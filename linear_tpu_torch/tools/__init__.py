"""Developer tools of the port, each run as `python -m
linear_tpu_torch.tools.<name> [--device cuda|cpu|host]` (default cuda):

  profile_stages    warm per-stage rates on the benchmark corpus: device
                    block seeding and extension, the native engine's stages
                    and phase split, the index builds, the seed wire's
                    copies and the seed kernel against its bound
  profile_residual  cProfile of the Python engine's residual after device
                    seeding and chaining
  bench_devbuild    the DIndex built on the device against the native host
                    build, cold and warm, checked equal
  bench_scale       genome-size scaling of preparation and PipelineMapper
                    mapping rates
  diffstage         a stage trace through Mapper.map_read (LINEAR_TPU_DBG),
                    and the diff of two traces

Counterparts of linear_tpu's tools/ scripts. On cuda each prints the card's
name and power limit (nvidia-smi) beside its times and raises without a
card; cpu runs the kernels' plain versions, host runs no device work.
"""
