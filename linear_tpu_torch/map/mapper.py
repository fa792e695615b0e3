"""Mapping orchestration: genomes + reads -> cords -> SAM/APF.

Counterpart of linear_tpu.map.mapper: the DIndex (-i 1), HIndex (-i 2) or
SIndex (-i 3), the 2_48 (-f 2), 1_16 (-f 0) or 1_32 (-f 1) features, device
seeding through ops.seeding, and one of two per-read engines:
  native  lt_engine does the per-read work (chaining, the apx tail, gaps,
          SAM); in the serial -b 0 loop on a device the dense-window
          extension (_filterHits + path_dst_2) runs on the device
          (ops.extend_dev) between the engine's first pass and its finish;
  Python  map.pmpfinder / chaining / gap and out.bamlink (or map.align for
          -a 1), selected by LINEAR_TPU_ENGINE=py or by what the native
          engine does not implement (-a 1, -i 3, -f 0/1); on a device the
          chain DP of each seeded read runs there (ops.chain_dp) and the
          engine starts from its tables.
On a genome without N the device builds its own DIndex tables
(ops.devbuild); otherwise the host build is uploaded. The device works on
the DIndex and the 2_48 features only (Mapper.device_work): with -i 2/3 or
-f 0/1 a device run maps on the host engines, as linear_tpu's does.

Devices (`device`, default cuda):
  host  the engine does all of it;
  cpu   the plain PyTorch versions of the kernels on CPU tensors;
  cuda  the hand-written CUDA kernels.
Nothing here falls back from a device to the host: a failed build, upload
or launch raises. Reads that the algorithm itself maps on the host (reads
with N, too many hits, overflowing cords, the re-apx path; for chaining,
too few or too many anchors and a window overflow) are counted by reason.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..index import dindex as DI
from ..ops import features as F
from ..out import bam as BAM
from ..out import bamlink as BL
from ..out.apf import print_cords_apf
from ..utils import dbg, seqio
from ..utils.cordscalar import anchor_x
from . import nengine as NE
from . import pmpfinder as PMP

THD_MIN_READ_LEN = 200  # src/mapper.cpp:430
MAX_SEED_READ_LEN = 1 << 17  # longest read the device seeds (pad 131072)
DEVICES = ("host", "cpu", "cuda")


@dataclass
class MapperConfig:
    """CLI-level options subset (reference Options, src/base.cpp:26-54)."""

    gap_len: int = 1           # -g; 0 disables the gap module
    apx_chain_flag: int = 1    # -c inverse; f_chain
    aln_flag: int = 0          # -a
    output_type: int = 2       # -ot; 1 apf, 2 sam, 4 bam, 8 pbsv-bam
    threads: int = 16          # -t (affects index build block decomposition)
    index_type: int = 1        # -i
    # -p; the reference's EFFECTIVE default is 1 (Options ctor sensitivity(1),
    # src/base.cpp:43; no CLI default registered): thd_DI=80, thd_X=200 and
    # anchor-chain stop-ratio 0 (src/mapper.cpp:181-188)
    preset: int = 1
    read_group: str = ""       # -rg (Options ctor default "", src/base.cpp:47)
    sample_name: str = ""      # -sn
    cmd_line: str = ""
    sequence_sam: int = 0      # -ss
    reform_ccs: int = 0        # -r (functional here; dead-wired in reference)
    f_dup: int = 0             # -dup
    bal_flag: int = 1          # -b; 0 = batch mode (deterministic omp-static
    #                            GapParms partition), 1 = pipeline schedule
    # -f; C++ setFeatureType dispatch (src/pmpfinder.cpp:59-73): 0 -> 1_16,
    # 1 -> 1_32, else 2_48
    feature_t: int = 2

    @property
    def thd_DI(self) -> int:
        return 80 if self.preset == 1 else BL.INF60

    @property
    def thd_X(self) -> int:
        return 200 if self.preset == 1 else BL.INF60

    @property
    def cah_stop_ratio(self) -> float:
        """ChainAnchorsHitsParms.thd_stop_chain_len_ratio: its ctor default
        0.7 survives only for preset 0; presets 1/2 zero it
        (src/mapper.cpp:174-197)."""
        return 0.7 if self.preset == 0 else 0.0


def chain_prepass(seeds) -> List[int]:
    """The host pre-pass the chain DP starts from (getAnchorHitsChains,
    src/pmpfinder.cpp:2506, :2448): filterAnchors on one read's seeds, then
    the std::sort-exact permutation by anchor-x, descending (the order of
    the anchors decides the DP)."""
    anchors = [0]
    anchors.extend(int(a) for a in seeds)
    PMP.filter_anchors(anchors, 1, 2, 2)
    return PMP.CXS.std_sort(anchors, [anchor_x(a) for a in anchors], desc=True)


@dataclass
class ExtendCounters:
    """What the -b 0 device extension did with the reads of a run. Every
    eligible read (200 < length <= MAX_SEED_READ_LEN, chain mode) is either
    extended on the device and finished from its cords, or mapped on the
    host for exactly one of the four reasons."""

    eligible: int = 0
    extended: int = 0
    host_n: int = 0         # N bases (the 2-bit read rows cannot carry them)
    host_hits: int = 0      # more than Mapper.EXT_H pre-filter hits
    host_overflow: int = 0  # a cord push would have passed slot C
    host_reapx: int = 0     # apx_finish: the y-gaps cover >= 0.7 of the read


@dataclass
class ChainCounters:
    """What the device chain DP did with the seeded reads of a run (the
    Python engine on a device). Every read with device seeds is either
    chained on the device or left to the engine's host DP for exactly one
    of JAX's three reasons (linear_tpu/map/mapper.py:322-324, :358-359)."""

    seeded: int = 0
    chained: int = 0
    host_few: int = 0       # fewer than 2 anchors after the filter
    host_many: int = 0      # more than CHAIN_MAX_N anchors
    host_overflow: int = 0  # a dx-depth lookback could reach past W


class Mapper:
    """Holds genomes, features and index; maps read blocks through the
    native or the Python engine, with seeds (and, for the Python engine,
    chain DP tables) from the device when `device` is cpu/cuda."""

    # superchunk rows per fused kernel launch and d2h of the streaming seed
    # path, and per-read anchor slots of its output (the tail column holds
    # count | probed << 32; probed > m_out redispatches at tier 2)
    SEED_SUPERCHUNK = 1024
    SEED_M_OUT = 128
    # tier 2: for reads whose probe overflowed SEED_M_OUT; 4x fewer rows
    # keep the mostly-padding (rows, m_out) output small
    SEED_M_OUT2 = 512
    SEED_SUPERCHUNK2 = 256
    # -b 0 extension: padded bases per kernel launch (rows x pad: 1024
    # reads at pad 8192; the scratch and the plain version's tensors grow
    # with it), and the pre-filter hits cap (JAX's EXT_H); reads with more
    # hits are mapped on the host
    EXT_BASES = 1 << 23
    EXT_H = 256
    # Python-engine chain DP: rows a launch (JAX's DEV_BATCH), the lookback
    # window, and the most anchors a read may have (more: the host DP)
    DEV_BATCH = 256
    CHAIN_W = 64
    CHAIN_MAX_N = 8192

    def __init__(self, genome_paths: List[str],
                 cfg: Optional[MapperConfig] = None, device: str = "cuda"):
        self.cfg = cfg or MapperConfig()
        if device not in DEVICES:
            raise ValueError(f"device {device!r}: use one of {DEVICES}")
        self.device = device
        gset = seqio.load_genomes(genome_paths)
        # genome ids are truncated at the first space (src/base.cpp:188-195)
        self.genome_ids = [g.split(" ")[0] for g in gset.ids]
        self.genomes = gset.seqs
        self.genome_lens = [len(s) for s in self.genomes]
        self.f2: List[PMP.Feats] = []  # per-genome feature scripts
        self.index = None  # DIndex, HIndex or SIndex (cfg.index_type)
        self._dev_index = None
        self._dev_gfeats = None
        # how the device index was made ("built" on the device, or
        # "uploaded" from the host build) and the seconds it took
        self.dev_index_source = ""
        self.dev_index_seconds = 0.0
        self.ext_counters = ExtendCounters()
        self.chain_counters = ChainCounters()
        self._nengine = None  # lazy per-process native engine
        # Python-engine state of the emulated compute threads (tid): the
        # persistent GapParms and the PMPParms toggle leak
        # (PMPParms.did_toggle)
        self._gap_parms: dict = {}
        self._pmp_toggled: dict = {}
        # per-tid read-feature buffers of -f 0/1 (PMP.FeatBuf: a shorter
        # read leaves the previous read's tail rows in place)
        self._f1_bufs: dict = {}

    def device_work(self) -> bool:
        """Whether the device does any of the mapping: only with the DIndex
        and the 2_48 features, as in linear_tpu (map/mapper.py:660-661)."""
        return (self.device != "host" and self.cfg.index_type == 1
                and self.cfg.feature_t == 2)

    def create_features(self) -> None:
        """The genomes' feature scripts, wrapped for the Python engine; the
        native engine reads their arrays. 2_48 (-f 2) from the native
        build (bit-equal to ops.features.create_features_genome); 1_16
        (-f 0) and 1_32 (-f 1) from ops.features."""
        PMP.set_feature_type(self.cfg.feature_t)
        if self.cfg.feature_t == 0:
            arrs = [F.create_features_1_16_parallel(s, self.cfg.threads)
                    for s in self.genomes]
        elif self.cfg.feature_t == 1:
            arrs = [F.create_features_1_32_parallel(s, self.cfg.threads)
                    for s in self.genomes]
        else:
            arrs = [NE.build_features_native(s, self.cfg.threads)
                    for s in self.genomes]
        if self.cfg.feature_t != 2 and dbg.enabled():
            for a in arrs:
                dbg.dbg_s("GFEA", a)
        self.f2 = [PMP.Feats(a) for a in arrs]

    def create_index(self) -> None:
        """The index of cfg.index_type: the DIndex (native build), the
        HIndex (native build with the engine on, else index.hindex's) or
        the SIndex."""
        if self.cfg.index_type == 3:
            from ..index import sindex as SI

            self.index = SI.build_sindex(self.genomes,
                                         threads_emul=self.cfg.threads)
        elif self.cfg.index_type == 2:
            from ..index import hindex as HI

            if NE.enabled():
                self.index = NE.build_hindex_native(
                    self.genomes, HI.DEFAULT_SPAN, HI.DEFAULT_STEP,
                    HI.DEFAULT_BLOCKLIMIT, HI.DEFAULT_ALPHA,
                    self.cfg.threads)
            else:
                self.index = HI.build_hindex(self.genomes,
                                             threads_emul=self.cfg.threads)
        else:
            self.index = DI.build_dindex(self.genomes, self.cfg.threads)

    def prepare(self) -> None:
        """Host-only set-up (features + index); touches no device, so a
        worker pool may fork after it."""
        if not self.f2:
            self.create_features()
        if self.index is None:
            self.create_index()

    # ------------------------------------------------------ device seeding

    def _ensure_dev_index(self):
        """The DIndex tables on the device, made on first use, and on cuda
        the kernel library built and loaded. When no genome has N the
        device builds the tables itself (ops.devbuild); otherwise the host
        build is uploaded. `dev_index_source` says which. Called only after
        the pipeline has forked its workers: that is when CUDA may first be
        initialised. Raises when the device or nvcc is missing, and when
        the build on the device fails."""
        if self._dev_index is None:
            if not self.device_work():
                raise ValueError(f"device {self.device!r} with -i "
                                 f"{self.cfg.index_type} -f "
                                 f"{self.cfg.feature_t} does not seed")
            import torch

            from ..ops import devbuild as DB
            from ..ops import seeding as SD

            if self.device == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("--device cuda: no CUDA device is "
                                       "available")
                from ..ops import _cuda

                _cuda.lib()
                # start the CUDA context here, so that dev_index_seconds
                # times the index alone
                torch.cuda.synchronize()
            t0 = time.time()
            if not any((s == 4).any() for s in self.genomes):
                index = DB.device_build_to_index(*DB.build_dindex_device(
                    self.genomes, self.device, self.cfg.threads))
                self.dev_index_source = "built"
            else:
                index = SD.upload_index(self.index.dir, self.index.hs,
                                        self.device)
                self.dev_index_source = "uploaded"
            if self.device == "cuda":
                torch.cuda.synchronize()
            self.dev_index_seconds = time.time() - t0
            if self.device == "cuda":
                # first use of the launch path (kernel module, pinned
                # buffers, copies) now, not while the workers wait on seeds
                w, n_mask = SD.pack_superchunk([], 1024, 1)
                SD.collect_wire(SD.dispatch_wire(w, index, self.SEED_M_OUT),
                                0, n_mask, self.SEED_M_OUT)
            self._dev_index = index
        return self._dev_index

    def _device_seed_block(self, reads: seqio.SeqSet) -> List:
        """Block seeding of a whole read block
        (linear_tpu/map/mapper.py:108-177): one entry a read, the device's
        anchors in emission order as uint64 arrays, or None for a read the
        device does not seed (200 bases or fewer, longer than
        MAX_SEED_READ_LEN, N bases, or a probe past SEED_M_OUT: no tier 2
        here), which the caller seeds on the host."""
        return self._device_seed_finish(reads,
                                        self._device_seed_dispatch(reads))

    def _device_seed_dispatch(self, reads: seqio.SeqSet):
        """The dispatch half of _device_seed_block: every superchunk of the
        eligible reads enqueued (SD.seed_block_dispatch) at the pad of the
        longest, a power of two of 1024 or more, with no wait. Returns
        (eligible read indices, dispatched superchunks or None)."""
        from ..ops import seeding as SD

        index = self._ensure_dev_index()
        eligible = [i for i, r in enumerate(reads.seqs)
                    if THD_MIN_READ_LEN < len(r) <= MAX_SEED_READ_LEN]
        if not eligible:
            return eligible, None
        pad = 1 << max(int(np.ceil(np.log2(max(
            len(reads.seqs[i]) for i in eligible)))), 10)
        return eligible, SD.seed_block_dispatch(
            [reads.seqs[i] for i in eligible], index, pad_len=pad,
            m_out=self.SEED_M_OUT, superchunk=self.SEED_SUPERCHUNK)

    def _device_seed_finish(self, reads: seqio.SeqSet, disp) -> List:
        """The wait half of _device_seed_block: per-read anchors."""
        from ..ops import seeding as SD

        eligible, block = disp
        out: List = [None] * len(reads.seqs)
        if block is not None:
            for i, a in zip(eligible, SD.seed_block_collect(
                    block, m_out=self.SEED_M_OUT)):
                out[i] = a
        return out

    def warmup(self, pad: int = 8192,
               n_buckets=(64, 128, 256, 512, 1024)) -> None:
        """Launch every kernel of the seeding paths once at the shapes they
        run (linear_tpu/map/mapper.py:439-467), so that no first launch
        falls inside a timed run: the device index (and on cuda the kernel
        library and the CUDA context), block seeding at (SEED_SUPERCHUNK,
        pad, SEED_M_OUT), the tier-2 wire at (SEED_SUPERCHUNK2, pad,
        SEED_M_OUT2), and the windowed chain DP at (DEV_BATCH, n) for each
        bucket n. Raises where _ensure_dev_index does (no device work, no
        card) and when a launch fails; on cpu the plain versions run."""
        import torch

        from ..ops import chain_dp as CDP
        from ..ops import seeding as SD

        index = self._ensure_dev_index()
        reads = [np.zeros(pad, dtype=np.uint8)] * self.SEED_SUPERCHUNK
        SD.seed_block_collect(SD.seed_block_dispatch(
            reads, index, pad_len=pad, m_out=self.SEED_M_OUT,
            superchunk=self.SEED_SUPERCHUNK), m_out=self.SEED_M_OUT)
        w2, n_mask2 = SD.pack_superchunk(reads[: self.SEED_SUPERCHUNK2], pad,
                                         self.SEED_SUPERCHUNK2)
        SD.collect_wire(SD.dispatch_wire(w2, index, self.SEED_M_OUT2),
                        self.SEED_SUPERCHUNK2, n_mask2, self.SEED_M_OUT2)
        cnt = torch.zeros((self.DEV_BATCH,), dtype=torch.int32,
                          device=self.device)
        for n in n_buckets:
            CDP.chain_dp_windowed(
                torch.zeros((self.DEV_BATCH, n), dtype=torch.int64,
                            device=self.device), cnt, W=self.CHAIN_W)
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _device_seed_stream2(self, chunks, counters=None):
        """Device seeding with m_out tiering, chunk by chunk. `chunks`
        yields (i0, seqs): consecutive reads of a block, seqs[0] being read
        i0. For every superchunk the device seeds, this yields
        (m_out, idx_list, anchors_list) as soon as it lands: idx are block
        read indices, anchors entries uint64 arrays or None (N bases, or an
        overflow of tier 2: the worker seeds those on the host). A chunk's
        eligible reads go out in superchunks of SEED_SUPERCHUNK at
        SEED_M_OUT; the reads whose probe overflowed go out again at once,
        in superchunks of SEED_SUPERCHUNK2 at SEED_M_OUT2, so every read of
        a chunk is final before the next chunk is read. Ineligible reads
        are never yielded. `counters` (a pipeline.PipeCounters) gets a span
        of each superchunk's pack, dispatch and collect when traced."""
        from ..ops import seeding as SD

        index = self._ensure_dev_index()
        span = (counters.span if counters is not None
                else lambda name: nullcontext())

        def seed(part, m_out):
            # part: (block index, read) pairs. A superchunk has one row per
            # read, so no padding rows ship; the anchors do not depend on pad
            seqs = [r for _, r in part]
            pad = 1 << max(int(np.ceil(np.log2(max(map(len, seqs))))), 10)
            with span("collector.pack"):
                w, n_mask = SD.pack_superchunk(seqs, pad, len(seqs))
            with span("collector.dispatch"):
                handle = SD.dispatch_wire(w, index, m_out)
            with span("collector.collect"):
                return SD.collect_wire(handle, len(seqs), n_mask, m_out)

        for i0, seqs in chunks:
            el = [(i0 + j, r) for j, r in enumerate(seqs)
                  if THD_MIN_READ_LEN < len(r) <= MAX_SEED_READ_LEN]
            for c0 in range(0, len(el), self.SEED_SUPERCHUNK):
                part = el[c0: c0 + self.SEED_SUPERCHUNK]
                anchors, overflow = seed(part, self.SEED_M_OUT)
                keep = [(i, a) for (i, _), a, ov in zip(part, anchors, overflow)
                        if not ov]
                yield (self.SEED_M_OUT, [i for i, _ in keep],
                       [a for _, a in keep])
                retry = [p for p, ov in zip(part, overflow) if ov]
                for r0 in range(0, len(retry), self.SEED_SUPERCHUNK2):
                    part2 = retry[r0: r0 + self.SEED_SUPERCHUNK2]
                    anchors2, _ = seed(part2, self.SEED_M_OUT2)
                    yield self.SEED_M_OUT2, [i for i, _ in part2], anchors2

    def _device_extend_block(self, reads: seqio.SeqSet, hits_list: List):
        """The device's _filterHits + path_dst_2 (ops.extend_dev) for the
        reads of a block whose hits_list entry is not None (the eligible
        reads): returns per-read uint64 cords arrays, None for the reads the
        host maps (N bases, more than EXT_H hits, overflowing cords), which
        ext_counters counts by reason. Consecutive reads form batches of at
        most EXT_BASES padded bases (or one read), at the pad of their
        longest read; all are launched before any is collected. The cords
        do not depend on the batching."""
        import torch

        from ..ops import extend_dev as ED

        if self._dev_gfeats is None:
            self._dev_gfeats = ED.upload_genome_feats(
                [f.arr for f in self.f2], self.device)
        ec = self.ext_counters
        out: List = [None] * len(reads.seqs)
        todo = []
        for i, (r, h) in enumerate(zip(reads.seqs, hits_list)):
            if h is None:
                continue
            ec.eligible += 1
            if (r == 4).any():
                ec.host_n += 1
            elif len(h) > self.EXT_H:
                ec.host_hits += 1
            else:
                todo.append(i)
        batches, chunk, pad = [], [], 0
        for i in todo:
            p = 1 << max(int(np.ceil(np.log2(len(reads.seqs[i])))), 10)
            if chunk and (len(chunk) + 1) * max(pad, p) > self.EXT_BASES:
                batches.append((chunk, pad))
                chunk, pad = [], 0
            chunk.append(i)
            pad = max(pad, p)
        if chunk:
            batches.append((chunk, pad))
        pending = []
        for chunk, pad in batches:
            packed, lens = ED.pack_rows([reads.seqs[i] for i in chunk], pad)
            hm = np.zeros((len(chunk), self.EXT_H), dtype=np.uint64)
            hn = np.zeros((len(chunk),), dtype=np.int32)
            for k, i in enumerate(chunk):
                hm[k, : len(hits_list[i])] = hits_list[i]
                hn[k] = len(hits_list[i])
            args = [torch.from_numpy(a).to(self.device)
                    for a in (packed, lens, hm.view(np.int64), hn)]
            pending.append((chunk, ED.filter_extend(
                *args, self._dev_gfeats, self.EXT_H + pad // 32)))
        for chunk, res in pending:
            cords, ncords, ovf = (t.cpu().numpy() for t in res)
            cords = cords.view(np.uint64)
            for k, i in enumerate(chunk):
                if ovf[k]:
                    ec.host_overflow += 1
                else:
                    out[i] = cords[k, : ncords[k]].copy()
        return out

    def _device_chain_block(self, seeded: List, raw: bool = False) -> List:
        """The device's chain DP (ops.chain_dp) for the reads whose seeds
        came from the device (entries of `seeded` not None), for the Python
        engine. Replays the host pre-pass that the DP starts from
        (chain_prepass) and runs the windowed getBestChains on the device, at
        most DEV_BATCH reads a launch at the power-of-two width (64 or more)
        of the launch's longest. Returns per read (sorted anchors,
        ChainsRecord list), or with raw=True the picklable (anchors, p2,
        score, length) arrays that pipeline workers rebuild records from;
        None where the engine's host DP runs: reads without device seeds,
        and the reads chain_counters counts by reason (fewer than 2 or more
        than CHAIN_MAX_N anchors, a window overflow). All launches go out
        before any result is read back."""
        import torch

        from ..ops import chain_dp as CDP

        cc = self.chain_counters
        out: List = [None] * len(seeded)
        pre: List[List[int]] = []
        idxs: List[int] = []
        for i, seeds in enumerate(seeded):
            if seeds is None:
                continue
            cc.seeded += 1
            anchors = chain_prepass(seeds)
            if len(anchors) < 2:
                # chainAnchorsBase returns at once
                cc.host_few += 1
            elif len(anchors) > self.CHAIN_MAX_N:
                cc.host_many += 1
            else:
                pre.append(anchors)
                idxs.append(i)
        pending = []
        for c0 in range(0, len(pre), self.DEV_BATCH):
            chunk = pre[c0: c0 + self.DEV_BATCH]
            N = max(1 << int(np.ceil(np.log2(max(map(len, chunk))))), 64)
            arr = np.zeros((len(chunk), N), dtype=np.uint64)
            cnt = np.zeros((len(chunk),), dtype=np.int32)
            for k, a in enumerate(chunk):
                arr[k, : len(a)] = a
                cnt[k] = len(a)
            pending.append((c0, CDP.chain_dp_windowed(
                torch.from_numpy(arr.view(np.int64)).to(self.device),
                torch.from_numpy(cnt).to(self.device), W=self.CHAIN_W)))
        for c0, res in pending:
            p2, score, length, overflow = (t.cpu().numpy() for t in res)
            for k, ovf in enumerate(overflow):
                r = c0 + k
                if ovf:
                    cc.host_overflow += 1
                    continue
                cc.chained += 1
                n = len(pre[r])
                if raw:
                    out[idxs[r]] = (pre[r], p2[k, :n].copy(),
                                    score[k, :n].copy(), length[k, :n].copy())
                else:
                    out[idxs[r]] = (pre[r], CDP.chain_records_from_dp(
                        p2[k], score[k], length[k], n))
        return out

    # ------------------------------------------------------ the engines

    def use_native(self) -> bool:
        """Whether the native engine maps the reads: not with
        LINEAR_TPU_ENGINE=py, nor with what it does not implement: -a 1,
        the SIndex, the 1_16 / 1_32 features (linear_tpu/map/mapper.py:
        507-513)."""
        return (NE.enabled() and not self.cfg.aln_flag
                and self.cfg.index_type in (1, 2) and self.cfg.feature_t == 2)

    def gap_parms(self, tid: int = 0):
        """The Python engine's persistent GapParms of emulated compute
        thread `tid` (the reference's per-thread gap_parms_set,
        src/mapper.cpp:233-237). The reference never resets it between
        reads and mapGaps mutates it, so later reads see the leaked values;
        see linear_tpu.map.mapper.Mapper.gap_parms for the -b 0 / -b 1
        thread structure."""
        if tid not in self._gap_parms:
            from . import gap as GAP

            # gap_len -> thd_gap_len_min (src/mapper.cpp:209-232): 1 -> 50
            # (default), 2..9 -> 10, >= 10 -> gap_len
            g = self.cfg.gap_len
            thd = 50 if g == 1 else (10 if g < 10 else g)
            self._gap_parms[tid] = GAP.GapParms(thd_gap_len_min=thd,
                                                f_dup=self.cfg.f_dup)
        return self._gap_parms[tid]

    def reset_gap_parms(self) -> None:
        """Start fresh emulated compute threads (per-task GapParms)."""
        self._gap_parms = {}
        self._pmp_toggled = {}
        self._f1_bufs = {}
        if self._nengine is not None:
            self._nengine.reset()

    def map_read_gen(self, read: np.ndarray, seed_anchors=None,
                     chain_pre=None, tid: int = 0):
        """The Python engine's apx phase of one read as a generator of
        window-sweep requests (pmpfinder.run_serial / run_lockstep); returns
        (cords_str, cords_end, cords_info, rc, f1). The gap phase is not
        part of it: it mutates the thread's GapParms, so it runs in read
        order (gap_phase). The thread's PMPParms start in ctor state and
        stay in toggle(0) state once a read on the thread took the re-apx
        path (PMPParms.did_toggle)."""
        if len(read) <= THD_MIN_READ_LEN:
            return [], [], [], None, None
        rc = seqio.revcomp(read)
        if self.cfg.feature_t != 2:
            st = self._f1_bufs.setdefault(tid, [PMP.FeatBuf(), PMP.FeatBuf()])
            vf, nf = F.feats1_parts(read, self.cfg.feature_t)
            vr, nr = F.feats1_parts(rc, self.cfg.feature_t)
            f1 = [st[0].update(vf, nf), st[1].update(vr, nr)]
            if dbg.enabled():
                dbg.dbg_s("RFEA", f1[0].arr[: f1[0].n_len])
                dbg.dbg_s("RFEB", f1[1].arr[: f1[1].n_len])
        else:
            f1 = [PMP.Feats(F.create_features_serial(read)),
                  PMP.Feats(F.create_features_serial(rc))]
        pm = PMP.PMPParms(seed_anchors=seed_anchors, chain_pre=chain_pre,
                          cah_stop_ratio=self.cfg.cah_stop_ratio)
        if self._pmp_toggled.get(tid):
            pm.toggle(0)
        cords_str, cords_end, _, cords_info = yield from PMP.apx_map(
            self.index, read, f1, self.f2, f_chain=self.cfg.apx_chain_flag,
            pm=pm)
        if pm.did_toggle:
            self._pmp_toggled[tid] = True
        return cords_str, cords_end, cords_info, rc, f1

    def map_read(self, read: np.ndarray, seed_anchors=None, chain_pre=None,
                 tid: int = 0):
        """One read through the Python engine (linear_tpu/map/mapper.py:
        577-584): the apx phase, then the gap phase on thread tid's
        GapParms, which carry state from read to read, so reads go in
        order. Returns (cords_str, cords_end, cords_info)."""
        cords_str, cords_end, cords_info, rc, f1 = PMP.run_serial(
            self.map_read_gen(read, seed_anchors=seed_anchors,
                              chain_pre=chain_pre, tid=tid))
        self.gap_phase(read, rc, cords_str, cords_end, f1, tid=tid)
        return cords_str, cords_end, cords_info

    def gap_phase(self, read, rc, cords_str, cords_end, f1,
                  tid: int = 0) -> None:
        """mapGaps + reformCords for one read, in read order. apx_gaps is
        an output parameter of mapGaps (recomputed there, src/gap.cpp:437),
        so a fresh list goes in."""
        if not self.cfg.gap_len or rc is None:
            return
        from . import gap as GAP

        GAP.map_gaps(self.genomes, read, rc, cords_str, cords_end, [], f1,
                     self.f2, self.gap_parms(tid))
        PMP._dbg("GAPF", cords_str)
        PMP._dbg("GAPE", cords_end)
        GAP.reform_cords(cords_str, cords_end)
        PMP._dbg("REFC", cords_str)

    def read_output(self, read: np.ndarray, rid: str, cords_str: List[int],
                    cords_end: List[int], collect_bam: bool = False):
        """The output of one read from its cords (the print side of
        p_calRecords, src/mapper.cpp:452-473): cords -> virtual-alignment
        records, or with -a 1 the base-level banded alignment of the cords
        windows (map.align, real =/X/I/D CIGARs). Returns (SAM text, BAM
        lines of out.bam, empty unless collect_bam)."""
        if self.cfg.aln_flag:
            from . import align as AL

            records = AL.align_cords(self.genomes, read, seqio.revcomp(read),
                                     cords_str, cords_end, band=100)
        else:
            records = BL.cords2bamlink(
                cords_str, cords_end, len(read), thd_large_X=8000,
                thd_DI=self.cfg.thd_DI, thd_X=self.cfg.thd_X)
        if self.cfg.reform_ccs:
            BL.reform_ccs_bams(records)
        BL.fill_bam_records(records, self.genome_ids, rid)
        if self.cfg.sequence_sam and records:
            BL.synth_seq(records, self.genomes, read, seqio.revcomp(read))
        sam = "".join(line + "\n" for line in BL.sam_lines(records))
        return sam, (BAM.records_to_bam_lines(records) if collect_bam else [])

    def py_map_reads(self, reads: List[np.ndarray], rids: List[str],
                     seeds: List, chain_pre: List, tids: List[int],
                     collect_bam: bool = False):
        """The Python engine over consecutive reads: the apx phase of all of
        them in lockstep (batched window sweeps; in read order with -c 0,
        whose alg-1 state leaks across reads), then the gap phase and the
        output of each in read order. Returns (cords_str list, cords_end
        list, SAM text, BAM lines) per read."""
        gens = [self.map_read_gen(r, seed_anchors=s, chain_pre=c, tid=t)
                for r, s, c, t in zip(reads, seeds, chain_pre, tids)]
        if self.cfg.apx_chain_flag:
            mapped = PMP.run_lockstep(gens)
        else:
            mapped = [PMP.run_serial(g) for g in gens]
        out = []
        for read, rid, tid, (cs, ce, _, rc, f1) in zip(reads, rids, tids,
                                                        mapped):
            self.gap_phase(read, rc, cs, ce, f1, tid=tid)
            out.append((cs, ce, *self.read_output(read, rid, cs, ce,
                                                  collect_bam)))
        return out

    def native_engine(self) -> NE.NativeEngine:
        """The per-process native engine, created lazily so forked pipeline
        workers each get their own instance state (the backing genome,
        feature and index arrays are shared copy-on-write)."""
        if self._nengine is None:
            if self.index is None:
                raise RuntimeError("prepare() the mapper first")
            g = self.cfg.gap_len
            gap_min = 0 if not g else (50 if g == 1 else (10 if g < 10 else g))
            self._nengine = NE.NativeEngine(
                self.genomes, [f.arr for f in self.f2], self.index,
                self.genome_ids,
                thd_DI=self.cfg.thd_DI, thd_X=self.cfg.thd_X,
                gap_len_min=gap_min, f_dup=self.cfg.f_dup,
                f_chain=self.cfg.apx_chain_flag,
                sequence_sam=self.cfg.sequence_sam,
                reform_ccs=self.cfg.reform_ccs,
                cah_stop_ratio=self.cfg.cah_stop_ratio)
        return self._nengine

    def native_map_read(self, read, rid: str, seeds=None, tid: int = 0,
                        collect_bam: bool = False):
        """One read through the native engine: returns (cords_str list,
        cords_end list, sam text, BAM lines); the BAM lines come from the
        engine's cords through read_output."""
        s = None if seeds is None else np.asarray(seeds, dtype=np.uint64)
        cs, ce, sam = self.native_engine().map_read(read, rid, seeds=s,
                                                    tid=tid)
        return self._with_bam(read, rid, cs, ce, sam, collect_bam)

    def _with_bam(self, read, rid: str, cs, ce, sam: str, collect_bam: bool):
        """The engine's (cords_str, cords_end, sam) of a read as int lists,
        with the read's BAM lines when asked for."""
        cs, ce = [int(c) for c in cs], [int(c) for c in ce]
        bl = (self.read_output(read, rid, cs, ce, collect_bam=True)[1]
              if collect_bam else [])
        return cs, ce, sam, bl

    @staticmethod
    def static_chunk_tids(n: int, threads: int) -> List[int]:
        """Per-read thread ids of the reference's `#pragma omp for` static
        partition in map_ (src/mapper.cpp:796-810): contiguous chunks of
        size n//threads, the first n%threads chunks one longer."""
        size2 = n // threads
        r = n - size2 * threads
        tids = []
        for t in range(threads):
            tids.extend([t] * (size2 + 1 if t < r else size2))
        return tids

    def map_block(self, reads: seqio.SeqSet, counters=None,
                  collect_bam: bool = False):
        """Map a block of reads in this process (the serial -b 0 block
        loop); returns (all_cords_str, all_cords_end, sam_text), and with
        collect_bam the block's BAM lines as a fourth. Where the device
        works (device_work; JAX's map_block, linear_tpu/map/mapper.py:
        649-734) it seeds the block. Then, with the Python engine, the device
        chains the seeded reads and the engine starts from those tables.
        With the native engine in chain mode (-c 1), the native first pass
        gives each eligible read its pre-filter hits, the device extends
        them, and the engine finishes each read from its cords
        (apx_finish); reads the device did not extend, or whose finish
        asks for the re-apx path, get the full native map with their device
        seeds. `counters` (a pipeline.PipeCounters) gets the seeding
        counts, and when traced the seeding spans."""
        n = len(reads.seqs)
        self._f1_bufs = {}
        if self.cfg.bal_flag == 0:
            tids = self.static_chunk_tids(n, self.cfg.threads)
        else:
            tids = [0] * n
        seeds: List = [None] * n
        on_device = self.device_work()
        if on_device:
            # as _SeedCollector.run: the counters go along only when traced
            kw = ({"counters": counters}
                  if counters is not None and counters.trace else {})
            for m_out, idxs, anchors in self._device_seed_stream2(
                    [(0, reads.seqs)], **kw):
                for i, a in zip(idxs, anchors):
                    seeds[i] = a
                if counters is not None:
                    counters.add_superchunk(m_out, m_out == self.SEED_M_OUT,
                                            idxs, anchors)
        if counters is not None:
            counters.fetched += n
            counters.shipped_seeded += sum(s is not None for s in seeds)
        if not self.use_native():
            chain_pre = (self._device_chain_block(seeds)
                         if on_device else [None] * n)
            mapped = self.py_map_reads(reads.seqs, reads.ids, seeds,
                                       chain_pre, tids, collect_bam)
        else:
            mapped = self._native_map_block(reads, seeds, tids, on_device,
                                            collect_bam)
        out = ([m[0] for m in mapped], [m[1] for m in mapped],
               "".join(m[2] for m in mapped))
        if collect_bam:
            return (*out, [ln for m in mapped for ln in m[3]])
        return out

    def _native_map_block(self, reads: seqio.SeqSet, seeds: List,
                          tids: List[int], on_device: bool,
                          collect_bam: bool) -> List:
        """map_block's native-engine branch: per read (cords_str,
        cords_end, sam, BAM lines)."""
        n = len(reads.seqs)
        dev_cords: List = [None] * n
        if on_device and self.cfg.apx_chain_flag:
            ne = self.native_engine()
            hits = [ne.apx_hits(r, s)
                    if THD_MIN_READ_LEN < len(r) <= MAX_SEED_READ_LEN
                    else None for r, s in zip(reads.seqs, seeds)]
            dev_cords = self._device_extend_block(reads, hits)
        mapped = []
        for rid, read, tid, s, dc in zip(reads.ids, reads.seqs, tids, seeds,
                                         dev_cords):
            res = None
            if dc is not None:
                res = self.native_engine().apx_finish(read, rid, dc, tid=tid)
                if res is None:
                    self.ext_counters.host_reapx += 1
                else:
                    self.ext_counters.extended += 1
                    res = self._with_bam(read, rid, *res, collect_bam)
            mapped.append(res or self.native_map_read(
                read, rid, seeds=s, tid=tid, collect_bam=collect_bam))
        return mapped

    def sam_header(self) -> str:
        return BL.sam_header(
            self.genome_ids, self.genome_lens,
            self.cfg.read_group, self.cfg.sample_name, self.cfg.cmd_line,
        )

    def apf_block(self, cords_set: List[List[int]], reads: seqio.SeqSet) -> str:
        return print_cords_apf(
            cords_set, self.genome_lens, self.genome_ids,
            [len(s) for s in reads.seqs], reads.ids,
        )
