"""Configuration for compression / decompression.

Defaults mirror the reference CLI defaults (reference: src/main.cpp:47-78 —
k=23, n=60, overlap-sketch-thr=6, minimap k=20/w=50, max-chain-iter=400,
edge-thr=4e6, t=20, decompression-memory=5 GB) so ratio comparisons are
apples-to-apples, but the knobs control a different, batch-first pipeline.

This is the PyTorch port's copy of ``nanospring_tpu/config.py``. It adds
``device`` (where the sketch and the batch DP run) and names ``aligner``'s
four backends after this package's devices; ``from_reference`` carries a
JAX-package config across field by field.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile


ALIGNERS = ("device", "native", "python", "auto")
DEVICES = ("cuda", "cpu")
# the JAX package's aligner names -> this package's
_REFERENCE_ALIGNER = {"tpu": "device"}


@dataclasses.dataclass
class CompressConfig:
    # --- MinHash sketching (reference: src/ReadFilter.cpp) ---
    kmer_size: int = 23                # -k: sketch k-mer length (<=32)
    num_hashes: int = 60               # -n: hash functions per sketch
    overlap_sketch_threshold: int = 6  # min matching sketch slots for a candidate
    sketch_seed: int = 0x5EEDF00D      # deterministic (reference uses random_device)

    # --- seeding / alignment (reference: minimap2 map-ont usage) ---
    seed_kmer_size: int = 20           # --minimap-k analog: anchor k-mer size
    seed_window: int = 50              # --minimap-w analog: minimizer window
    max_bucket: int = 256              # sketch-slot bucket cap (buckets
                                       # larger than this are repetitive
                                       # k-mers and skipped; drops counted
                                       # in FunnelStats.capped_* — measured
                                       # at 256/1024/uncapped in
                                       # docs/BUCKET_CAP.md)
    max_chain_iter: int = 400          # chaining iteration cap analog
    band_width: int = 128              # banded-DP half-width for extension
    band_width_min: int = 64           # adaptive first-try band (native
                                       # engine escalates to band_width on
                                       # rejection; tighter bands give
                                       # tighter scripts AND less DP work)
    max_edit_frac: float = 0.5         # reject alignment if edits/len above this
    min_overlap: int = 150             # min overlapping bases to accept a member
    max_place_attempts: int = 8        # stale-clip retry cap per candidate
                                       # (engine.cpp apply(); gates how hard
                                       # end-extension races are retried)

    # --- contig building (reference: src/Consensus.cpp) ---
    edge_threshold: int = 4_000_000    # --edge-thr analog: cap on contig work
    min_read_len_for_sketch: int = 32  # reads shorter than this are lone reads
    repetitive_offsets: int = 6        # self-similarity screen offsets 1..6
    repetitive_threshold: float = 0.7  # Hamming self-similarity cutoff
    polish_rounds: int = 1             # consensus column-voting rounds

    # --- batching ---
    sketch_batch_reads: int = 4096     # reads per sketch-index query batch
                                       # (the sketch itself is one launch)
    align_batch: int = 512             # (window, candidate) pairs per align launch
    frontier_target: int = 96          # queue depth the seeder tops up to;
                                       # more = fuller align batches but more
                                       # concurrent contigs (fragmentation)

    # --- pipeline selection ---
    disable_assembly: bool = False     # True: every read stored lone (testing)
    short_read_lone_threshold: int = 256  # avg read length below which
                                       # assembly is skipped: per-member
                                       # stream overhead (~15-20 B) rivals a
                                       # packed short read, while the BWT
                                       # codec already captures the cross-
                                       # read coverage redundancy in the
                                       # lone stream (measured on the
                                       # new_zymo-like regime: lone-only
                                       # 4.8x vs assembled 4.0x; reference
                                       # gets 3.88x, logs/2022/new_zymo.log)
    checks: bool = False               # validate every member's edit script
                                       # against the live consensus (the
                                       # reference's -DCHECKS replay equality,
                                       # src/Consensus.cpp:280-337); slow
    aligner: str = "device"            # "device" = the banded-DP kernel
                                       # (csrc/banded_dp16.cu on cuda, its
                                       # plain torch version on cpu) as the
                                       # engine's batch DP backend;
                                       # "native" = C++ stitched/banded DP;
                                       # "python" = the Python wavefront
                                       # (grow loop in Python) with its
                                       # batch DP in csrc/banded_dp32.cu
                                       # (plain torch version on cpu),
                                       # band fixed at [-128, 127];
                                       # "auto" = the engine times one
                                       # batch on the device DP and on its
                                       # own and keeps the faster (on cuda,
                                       # above NSTPU_PROBE_MIN_BASES bases
                                       # or with NSTPU_TPU_PROBE=1; else
                                       # the engine's own DP)
    device: str = "cuda"               # "cuda" | "cpu": where the sketch
                                       # and the device DP run; "cuda"
                                       # without a card raises

    # --- resources ---
    num_threads: int = 0               # 0 = os.cpu_count(); host-side pools
    pipeline_workers: int = 0          # contig-growth processes (0 = auto);
                                       # components are disjoint, so workers
                                       # (or hosts) need no coordination
    low_mem: bool | None = None        # disk-backed read store; None = auto
                                       # (on above low_mem_auto_bytes input
                                       # size — the in-memory worker fan-out
                                       # would otherwise duplicate the packed
                                       # dataset per worker)
    low_mem_auto_bytes: int = 2 << 30  # auto threshold on input file size
    work_dir: str | None = None        # temp dir root (None -> system tmp)

    # --- codec stage (reference: src/Compressor.cpp:126-130) ---
    # Per-stream winners, measured in docs/CODECS.md: the from-scratch LZ77
    # + range coder (nslz, the fast-lzma2 role) owns .pos and .base (beats
    # both nsbwt and stdlib lzma-6 on .base, within 0.6% of lzma-6 on
    # .pos); the from-scratch BWT codec (nsbwt, the libbsc role) owns the
    # rest. "lzma"/"bz2"/"zlib" remain available per stream.
    base_codec: str = "nslz"           # .base stream codec (LZ77 wins the
                                       # near-random literal stream)
    pos_codec: str = "nsbwt"           # .pos stream codec (LZP+BWT order-1
                                       # beats lzma-6 and nslz; docs/CODECS.md)
    default_codec: str = "nsbwt"       # remaining streams (incl .lone)
    exc_codec: str = "nso1"            # .exc stream codec (order-1 range
                                       # coder, no transform: the position
                                       # varints are near-uniform, which a
                                       # BWT scrambles; beats lzma-6 —
                                       # docs/CODECS.md)

    def __post_init__(self) -> None:
        if self.aligner not in ALIGNERS:
            raise ValueError(f"aligner must be one of {ALIGNERS}, "
                             f"got {self.aligner!r}")
        if self.device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}, "
                             f"got {self.device!r}")
        if self.aligner == "python" and self.band_width > 128:
            raise ValueError("aligner='python' runs banded_dp32, whose band "
                             "is fixed at [-128, 127]: band_width must be "
                             f"<= 128, got {self.band_width}")

    @classmethod
    def from_reference(cls, d: dict, **overrides) -> "CompressConfig":
        """Build the port's config from ``dataclasses.asdict()`` of a JAX
        ``nanospring_tpu.config.CompressConfig``.

        Every shared field is carried as is; the reference's padding-bucket
        and window-step knobs have no counterpart here and are dropped. The
        reference's chip aligner ("tpu") maps to "device"; its default
        "auto" (the engine's timed probe between the chip's DP and its own)
        maps to "auto", which probes the device DP the same way where the
        device is a card. "python" maps to "python",
        the wavefront with its batch DP (``banded_dp32``) on ``device``. Its
        counterpart in the JAX package is the wavefront's route through the
        v1 kernel (``aligner="tpu"`` with no C++ engine). The JAX
        ``"python"`` runs the host DP instead: where both accept a pair the
        costs are equal (up to the host band's one extra diagonal) and the
        scripts differ at ties, but the host DP also rejects divergent
        pairs early (its divergence-slope abort), which the kernel
        accepts. ``overrides`` are applied last (e.g. ``device="cpu"``).
        """
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "aligner" in kw:
            kw["aligner"] = _REFERENCE_ALIGNER.get(kw["aligner"],
                                                   kw["aligner"])
        kw.update(overrides)
        return cls(**kw)

    def torch_device(self):
        """The ``torch.device`` the sketch and the device DP run on. Asking
        for ``cuda`` where there is no card raises: nothing falls back to
        the CPU unasked."""
        import torch

        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch.cuda.is_available() "
                "is False: pass device='cpu' (CLI: --device cpu) to run the "
                "sketch and the DP's plain PyTorch versions on the CPU")
        return torch.device(self.device)

    def resolved_threads(self) -> int:
        return self.num_threads or (os.cpu_count() or 1)

    def effective_min_overlap(self, avg_len: float) -> int:
        """min_overlap scaled down for short-read datasets (a 97-base
        new_zymo-style read can never reach the 150-base default; the
        reference accepts any alignment with >= 1 SAME base,
        src/ConsensusGraph.cpp:391-397)."""
        return min(self.min_overlap, max(24, int(avg_len * 0.6)))

    def effective_seed_window(self, avg_len: float) -> int:
        """Minimizer window scaled down for short reads so every read
        still carries a usable anchor set (the reference scales its
        consensus window step by avgReadLen the same way,
        src/Consensus.cpp:54)."""
        return min(self.seed_window, max(8, int(avg_len // 8)))

    def resolved_workers(self) -> int:
        """Contig-growing worker processes (owner-computes over components).

        Each worker runs a 2-thread software pipeline (placement thread +
        OpenMP DP), so one worker per two cores; fewer cores than that and
        the single pipelined worker wins outright.
        """
        if self.pipeline_workers:
            return self.pipeline_workers
        cores = os.cpu_count() or 1
        return max(1, min(self.resolved_threads(), cores) // 2)

    def resolved_work_root(self) -> str:
        return self.work_dir or tempfile.gettempdir()


@dataclasses.dataclass
class DecompressConfig:
    memory_gb: float = 5.0             # --decompression-memory analog: reorder budget
    num_threads: int = 0
    work_dir: str | None = None

    def resolved_threads(self) -> int:
        return self.num_threads or (os.cpu_count() or 1)

    def resolved_work_root(self) -> str:
        return self.work_dir or tempfile.gettempdir()
