"""The DIndex build at chr21 scale: the native host build against the
device build (ops.devbuild, csrc/devbuild.cu), cold and warm, on a random
genome of `mbases` Mb (default 46.7, numpy.random.default_rng(21)).
Counterpart of linear_tpu's tools/bench_devbuild.py.

    python -m linear_tpu_torch.tools.bench_devbuild [mbases] [--device D]

The cold device build is the process's first: the kernel library's load
(its nvcc build, when _build/ has none) and the CUDA context included; the
warm build is the next one. Both device builds must give the host build's
dir and hs exactly, or the tool exits 1. With --device host only the host
build runs. On cuda the card's nvidia-smi line heads the output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import common

# -t of the index's sampling, as linear_tpu's tool builds it
THREADS = 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linear_tpu_torch.tools.bench_devbuild",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("mbases", type=float, nargs="?", default=46.7)
    common.add_device_arg(ap)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line")
    args = ap.parse_args(argv)

    from ..index import dindex as DI

    glen = int(args.mbases * 1e6)
    genome = np.random.default_rng(21).integers(0, 4, glen).astype(np.uint8)
    out = {"genome_bases": glen, "device": args.device}
    t0 = time.time()
    host = DI.build_dindex([genome], THREADS)
    out["host_build_s"] = time.time() - t0
    out["entries"] = int(len(host.hs))
    if args.device != "host":
        import torch

        from ..ops import devbuild as DB

        out["card"] = common.card(args.device)
        t0 = time.time()
        if args.device == "cuda":
            from ..ops import _cuda

            _cuda.lib()
        launches = DB.launches
        equal = []
        for name in ("cold", "warm"):
            dirp, hs, _ = DB.build_dindex_device([genome], args.device,
                                                 THREADS)
            common.sync(args.device)
            out[f"device_{name}_s"] = time.time() - t0
            equal.append(bool(torch.equal(dirp.cpu(), torch.from_numpy(
                np.ascontiguousarray(host.dir, dtype=np.int32))))
                and bool(np.array_equal(hs.cpu().numpy().view(np.uint64),
                                        host.hs)))
            t0 = time.time()
        out["build_kernel_launches"] = DB.launches - launches
        out["device_equal_host"] = all(equal)
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>22}: {v}")
    if out.get("device_equal_host") is False:
        print("bench_devbuild: the device build differs from the host build",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
