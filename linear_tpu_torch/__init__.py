"""linear_tpu_torch — the PyTorch + CUDA port of linear_tpu for one NVIDIA H100.

The package mirrors linear_tpu's layout and module names, so each module's
counterpart is easy to find:

  - `linear_tpu_torch.ops`      the hand-written CUDA kernels (ops/csrc:
                                seeding, extension, index build, chain DP,
                                the mesh path's padded seeding and
                                compaction),
                                each beside its plain PyTorch version; the
                                numpy feature scripts and k-mer hashing
  - `linear_tpu_torch.index`    the DIndex tables (built by the native engine)
                                and their numpy query
  - `linear_tpu_torch.map`      the mapper, the ctypes binding of the native
                                per-read engine, and the Python engine
  - `linear_tpu_torch.out`      SAM records, SAM header and APF emission
  - `linear_tpu_torch.utils`    seq I/O, packed-u64 cord bit formats, the
                                synthetic corpus generator
  - `linear_tpu_torch.parallel` the feeder / worker-pool / ordered-drain
                                pipeline, and the multi-process mesh path
                                over torch.distributed (dist, mesh, e2e)
  - `linear_tpu_torch.native`   g++ build of the port's copy of the C++
                                runtime (native/src)

It imports torch, numpy and ctypes, never jax or linear_tpu. The C++ runtime
is the port's own byte-for-byte copy of linear_tpu's sources.
"""

__version__ = "0.1.0"
