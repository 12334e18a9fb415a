"""Profiling harnesses of the port, one for each TPU harness under scripts/
that reaches `pl.pallas_call` (P1-P6). Each runs on the card as

    python -m gsvc_tpu_torch.scripts.<name> [--num-points 10000 --height 1080 --width 1920 --iters N]

at the bench scene (bench.py's, seed 0; `common.bench_scene`) and exits
non-zero without a CUDA device: a timing is never taken on the CPU. On the
CPU their pieces run only through tests/test_torch_profiling.py.

- profile_micro_ops (P3): each op alone, every kernel K1-K6 beside its
  bound, its launches a step and its library call;
- profile_fwd_chain (P2): cumulative prefixes of the eval forward;
- profile_bwd_chain (P4): the train step's backward, stage by stage;
- profile_kernel_parts (P1): K4 with one part ablated or re-typed;
- probe_transpose (P6): the transposes of K5's planar store;
- profile_bwd_variants (P5): the job-based backward, variants A-E.
"""
