"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version:

- `fatrow_expand` (K1): the packed beam expansion, every packed hop;
- `block_patch` (K2): whole-fat-row writes into the packed word table;
- `hop_merge` (K3): the rest of a packed list-walk hop after K1 (the
  candidates' distances, dedup, merge and the next beam);
- `router_topk` (K4): the bf16 router's product, epilogue and
  top-n_start in one pass over the router table.

The CUDA sources live in `csrc/` and are built by `native` at first use.
"""
