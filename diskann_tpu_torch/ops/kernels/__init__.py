"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version:

- `fatrow_expand` (K1): the packed beam expansion, every packed hop;
- `block_patch` (K2): whole-fat-row writes into the packed word table;
- `hop_merge` (K3): the rest of a packed list-walk hop after K1 (the
  candidates' distances, dedup, merge and the next beam).

The CUDA sources live in `csrc/` and are built by `native` at first use.
"""
