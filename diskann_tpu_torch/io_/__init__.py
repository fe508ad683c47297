"""Dataset and index IO (copies of `diskann_tpu/io_/`: numpy only): the
fbin / fvecs readers and writers, and the versioned record format that
`GraphIndex.save` / `load` write and read, byte for byte the JAX package's."""

from diskann_tpu_torch.io_.fbin import read_fbin, read_fvecs, read_ivecs, write_fbin
from diskann_tpu_torch.io_.record import load_record, save_record

__all__ = ["read_fbin", "write_fbin", "read_fvecs", "read_ivecs", "save_record",
           "load_record"]
