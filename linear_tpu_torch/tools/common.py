"""What the developer tools and chip_smoke.py share: the --device argument,
the card's nvidia-smi line, the least time of a kernel's work, and the
benchmark corpus."""
from __future__ import annotations

import os
import subprocess

import numpy as np

from ..map.mapper import DEVICES

# the least time of a kernel's work: its bytes over the H100 SXM's HBM3 rate,
# or its integer operations over the card's rate outside the tensor cores
# (67 T/s, the H100 SXM's float32 non-tensor peak, taken for its integer rate
# too), whichever is larger
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12

# the corpus: bench.py's BASELINE config-1 analog (bench.py:37-98), a 4.6 Mb
# E. coli-scale genome with assembly N-gaps and 10,240 CLR-like reads of
# about 7 kb, made by utils.simdata from SEED
GENOME_LEN = 4_600_000
N_READS = 10240
READ_LEN = 7000
SEED = 42


def add_device_arg(ap) -> None:
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="cuda: the CUDA kernels (default); cpu: their plain "
                         "versions; host: no device work")


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def card(device: str) -> str:
    """What ran a tool's device work, printed beside its times: on cuda
    the nvidia-smi line (raises without a card). This asks CUDA whether a
    card is there, so a tool that forks a worker pool calls it after the
    fork."""
    if device != "cuda":
        return f"device {device}: no card (times are the CPU's)"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return nvidia_smi()


def sync(device: str) -> None:
    """Wait for the device's queued work (cuda only)."""
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and bound_by of a kernel's work (see HBM_BYTES_S)."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_o = ops / SCALAR_OPS_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def n_calls(lens, thd_alpha: int = 15) -> int:
    """In-range call positions of reads of these lengths (k = 35 + 15p
    < len - 21): what the seeding kernels probe at most."""
    lens = np.asarray(lens, dtype=np.int64)
    return int(np.maximum(0, -(-(lens - 56) // thd_alpha)).sum())


def seed_bound(wire_bytes: int, rows: int, m_out: int, lens,
               probed) -> dict:
    """The seed superchunk kernel's bound: the wire in, the rows out, two
    dir words a call position and an hs entry a probed slot below m_out;
    ~150 operations a position (window, nine candidates, YValue), ~20 a
    slot."""
    calls = n_calls(lens)
    slots = int(np.minimum(np.asarray(probed), m_out).sum())
    return bound(wire_bytes + rows * (m_out + 1) * 8 + 8 * calls + 8 * slots,
                 150 * calls + 20 * slots)


def build_dir(*parts: str) -> str:
    """A directory under the package's gitignored _build/."""
    from ..native import BUILD_DIR

    d = os.path.join(BUILD_DIR, *parts)
    os.makedirs(d, exist_ok=True)
    return d


def make_corpus(d: str, genome_len: int = GENOME_LEN, n_reads: int = N_READS,
                read_len: int = READ_LEN, seed: int = SEED):
    """The corpus' genome and reads as FASTA files in d, written once:
    returns (genome codes, genome path, reads path). Another size or seed
    than the default gets files of its own."""
    from ..utils import seqio, simdata

    tag = ("" if (genome_len, read_len, seed) == (GENOME_LEN, READ_LEN, SEED)
           else f"_{genome_len}_{read_len}_{seed}")
    g_fa = os.path.join(d, f"genome{tag}.fa")
    r_fa = os.path.join(d, f"reads{n_reads}{tag}.fa")
    rng = np.random.default_rng(seed)
    genome = simdata.make_genomic_genome(rng, genome_len)
    if not (os.path.exists(g_fa) and os.path.exists(r_fa)):
        reads = simdata.simulate_reads(rng, genome, n_reads, read_len)
        seqio.write_fasta(g_fa + ".tmp", ["U00096.3 synthetic"], [genome])
        seqio.write_fasta(r_fa + ".tmp",
                          [f"read{i} sim" for i in range(n_reads)], reads)
        os.replace(g_fa + ".tmp", g_fa)
        os.replace(r_fa + ".tmp", r_fa)
    return genome, g_fa, r_fa
