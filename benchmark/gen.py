"""Seeded nanopore-like FASTQ generator for the benchmark's configurations.

A frozen copy of the port's ``utils/synth.py`` realistic model
(homopolymer-enriched genome with segmental repeats; reads with
homopolymer-biased indels, substitutions, lognormal lengths, random strand),
vectorised so that only the bases that err are touched one by one, and
extended to a mix of genomes, each with its own share of the bases. It
imports nothing of the program.

What is fixed by the configuration and what by the run's seed: the
configuration's ``shape_seed`` fixes the genomes (the organisms of the
deployment), every read (its genome, start, strand, length and sequencing
errors) and their order in the file; the run's seed draws the reads'
names, which the port does not store. Every seed thus gives the
compressor the same work. On the card, reads drawn anew from the seed
moved the ratio by up to 10% and the device DP's rejects threefold
between seeds, and the same reads in an order drawn from the seed still
moved `sa`'s ratio by 6% (15.94-16.88): the engine seeds its contigs in
read order.

Run as a script it writes, into ``--out``, ``reads.fastq`` (the job's
input), ``warmup.fastq`` (a slice of the reads with the longest one in it)
and ``reads.json`` (counts); ``benchmark/run.py`` starts it as a child
process, so that the harness's own copy of the data never sets the
high-water mark of the process that runs the jobs.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
CHUNK_BASES = 8 << 20


def genome_codes(length: int, rng: np.random.Generator, p_hp: float,
                 repeat_frac: float, repeat_len, repeat_ident) -> np.ndarray:
    """Codes 0..3 (A, C, G, T) of one genome: each base repeats its
    predecessor with extra probability ``p_hp``, then ``repeat_frac`` of it
    is overwritten with copies of other segments at ``repeat_ident``
    identity (``synth.realistic_genome``)."""
    codes = rng.integers(0, 4, size=length).astype(np.uint8)
    same = rng.random(length) < p_hp
    same[0] = False
    anchor = np.where(~same, np.arange(length), 0)
    np.maximum.accumulate(anchor, out=anchor)
    g = codes[anchor]
    lo, hi = repeat_len
    if length >= 4 * lo:
        target = int(length * repeat_frac)
        placed = 0
        while placed < target:
            n = int(rng.integers(lo, min(hi, length // 4) + 1))
            src = int(rng.integers(0, length - n))
            dst = int(rng.integers(0, length - n))
            ident = float(rng.uniform(*repeat_ident))
            seg = g[src:src + n].copy()
            mut = rng.random(n) < (1.0 - ident)
            seg[mut] = rng.integers(0, 4, size=int(mut.sum()))
            g[dst:dst + n] = seg
            placed += n
    return g


def read_plan(cfg: dict) -> tuple[list[np.ndarray], np.ndarray, np.ndarray]:
    """The configuration's genomes, and per read its genome index and its
    length before errors, all from ``shape_seed``. Reads are given to the
    genomes in proportion to their share of the bases; lengths follow the
    lognormal law at the published mean, at least ``min_len``, at most the
    genome."""
    rng = np.random.default_rng(cfg["shape_seed"])
    gm = cfg["genome_model"]
    genomes = [genome_codes(int(g["length"]), rng, gm["p_hp"],
                            gm["repeat_frac"], gm["repeat_len"],
                            gm["repeat_ident"]) for g in cfg["genomes"]]
    n = int(cfg["num_reads"])
    share = np.array([g["base_share"] for g in cfg["genomes"]], np.float64)
    share = share / share.sum()
    counts = np.floor(share * n).astype(np.int64)
    rest = np.argsort(-(share * n - counts), kind="stable")
    counts[rest[: n - int(counts.sum())]] += 1
    gidx = np.repeat(np.arange(len(genomes)), counts)
    law = cfg["reads"]
    sigma = float(law["sigma"])
    mu = np.log(float(cfg["mean_read_len"])) - sigma * sigma / 2.0
    lens = rng.lognormal(mu, sigma, n).astype(np.int64)
    lens = np.maximum(int(law["min_len"]), lens)
    glen = np.array([len(g) for g in genomes], np.int64)
    lens = np.minimum(lens, glen[gidx])
    return genomes, gidx, lens


def _indel_scales(genome: np.ndarray, law: dict) -> tuple[float, float]:
    """Indel rate multipliers (inside, outside) a homopolymer run: inside
    ``1 + hp_bias`` times outside, the genome's mean indel rate kept
    (``synth.mutate`` keeps each read's; the genome's differs from it only
    by the read's sampling)."""
    frac = float(np.mean(genome[1:] == genome[:-1]))
    hp = float(law["hp_bias"])
    return (1.0 + hp) / (1.0 + hp * frac), 1.0 / (1.0 + hp * frac)


def _mutate(seq: np.ndarray, lens: np.ndarray, scales: np.ndarray,
            rng: np.random.Generator, law: dict) -> tuple[np.ndarray, np.ndarray]:
    """Errors in concatenated reads (codes, per-read lengths, per-read
    indel scales (inside, outside runs)). At each base a 16-bit draw ``r``
    against the base's rates makes it a deletion (``r < p_del``), a
    substitution to another base (``r < p_del + p_sub``) or an insertion
    before it (``r < p_del + p_sub + p_ins``), the indel rates scaled by
    ``_indel_scales``. Only the bases that err are touched after the one
    pass that draws and compares."""
    n = len(seq)
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    p_del, p_sub, p_ins = (float(law[k]) for k in ("p_del", "p_sub", "p_ins"))
    total = np.round(((p_del + p_ins) * scales + p_sub) * 65536)
    r = np.frombuffer(rng.bytes(2 * n), np.uint16)
    # bases under the highest limit of the chunk, then each against its own
    at = np.flatnonzero(r < total.max())
    rid = np.searchsorted(starts, at, side="right") - 1
    in_run = (at > starts[rid]) & (seq[at] == seq[np.maximum(at - 1, 0)])
    side = np.where(in_run, 0, 1)
    hit = r[at] < total[rid, side]
    at, rid, side = at[hit], rid[hit], side[hit]
    sc = scales[rid, side]
    x = r[at] / 65536.0
    is_del = x < p_del * sc
    is_sub = ~is_del & (x < p_del * sc + p_sub)
    is_ins = ~is_del & ~is_sub
    sub = at[is_sub]
    seq = seq.copy()
    seq[sub] = (seq[sub] + rng.integers(1, 4, size=len(sub),
                                        dtype=np.uint8)) & 3
    dels = at[is_del]
    ins = at[is_ins]
    kept = np.delete(seq, dels)
    out = np.insert(kept, ins - np.searchsorted(dels, ins),
                    rng.integers(0, 4, size=len(ins), dtype=np.uint8))
    new_lens = (lens - np.bincount(rid[is_del], minlength=len(lens))
                + np.bincount(rid[is_ins], minlength=len(lens)))
    return out, new_lens


class Plan:
    """The configuration's reads, in the configuration's order: the
    genomes, and per read its genome, start, strand, length and errors, all
    from ``shape_seed``; cut into chunks of whole reads, about
    ``CHUNK_BASES`` bases each, each with its own random stream, so a chunk
    is the same whichever process makes it."""

    def __init__(self, cfg: dict):
        genomes, gidx, lens = read_plan(cfg)
        self.law = cfg["reads"]
        self.genomes = genomes
        self.scale_g = np.array([_indel_scales(g, self.law) for g in genomes])
        place, errors = np.random.SeedSequence(
            [int(cfg["shape_seed"]), 1]).spawn(2)
        rng = np.random.default_rng(place)
        # the file's order interleaves the genomes
        order = rng.permutation(len(lens))
        gidx, lens = gidx[order], lens[order]
        self.gidx, self.lens = gidx, lens
        glen = np.array([len(g) for g in genomes], np.int64)
        self.starts = rng.integers(0, glen[gidx] - lens + 1)
        self.flip = rng.random(len(lens)) < float(self.law["p_revcomp"])
        ends = np.cumsum(lens)
        bounds = np.searchsorted(ends, np.arange(CHUNK_BASES, int(ends[-1]),
                                                 CHUNK_BASES),
                                 side="left") + 1
        self.cuts = np.unique(np.concatenate([[0], bounds, [len(lens)]]))
        self.streams = errors.spawn(len(self.cuts) - 1)

    def chunk(self, c: int) -> tuple[np.ndarray, np.ndarray]:
        """Chunk ``c``'s reads: (ASCII bases, per-read lengths)."""
        a, b = int(self.cuts[c]), int(self.cuts[c + 1])
        parts = []
        for i in range(a, b):
            s = self.genomes[self.gidx[i]][self.starts[i]:
                                           self.starts[i] + self.lens[i]]
            # a read of the reverse strand: its errors fall in read order
            parts.append(3 - s[::-1] if self.flip[i] else s)
        seq, lens = _mutate(np.concatenate(parts), self.lens[a:b],
                            self.scale_g[self.gidx[a:b]],
                            np.random.default_rng(self.streams[c]), self.law)
        return ASCII[seq], lens


def fastq_bytes(reads: list[bytes], names: list[int]) -> bytes:
    """FASTQ records named ``@<16 hex digits>`` with a constant quality
    line: the port stores read sequences only, as NanoSpring does."""
    qual = b"F" * max((len(r) for r in reads), default=0)
    return b"".join(b"@%016x\n%s\n+\n%s\n" % (n, r, qual[:len(r)])
                    for n, r in zip(names, reads))


_PLAN: Plan | None = None   # a pool worker's plan, set by its initializer


def _init_worker(cfg: dict) -> None:
    global _PLAN
    _PLAN = Plan(cfg)


def _chunk(c: int, plan: Plan | None = None) -> tuple[bytes, np.ndarray]:
    bases, lens = (plan or _PLAN).chunk(c)
    return bases.tobytes(), lens


def write_run(cfg: dict, seed: int, out_dir: str, warmup_reads: int,
              workers: int = 1) -> dict:
    """Write one run's ``reads.fastq`` (the configuration's reads, named
    from ``seed``), ``warmup.fastq`` (its first ``warmup_reads`` reads and
    its longest) and ``reads.json``, making the chunks in ``workers``
    processes."""
    plan = Plan(cfg)
    chunks = range(len(plan.cuts) - 1)
    if workers > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        with cf.ProcessPoolExecutor(workers, mp.get_context("spawn"),
                                    initializer=_init_worker,
                                    initargs=(cfg,)) as pool:
            parts = list(pool.map(_chunk, chunks))
    else:
        parts = [_chunk(c, plan) for c in chunks]
    reads = []
    for raw, lens in parts:
        p = 0
        for ln in lens.tolist():
            reads.append(raw[p:p + ln])
            p += ln
    del parts
    names = np.random.default_rng(seed).integers(
        0, 2**63, len(reads)).tolist()
    lens = np.array([len(r) for r in reads], np.int64)
    with open(os.path.join(out_dir, "reads.fastq"), "wb") as f:
        step = 1024
        for a in range(0, len(reads), step):
            f.write(fastq_bytes(reads[a:a + step], names[a:a + step]))
    longest_id = int(np.argmax(lens))
    warm = list(range(min(warmup_reads, len(reads))))
    if longest_id >= warmup_reads:
        warm.append(longest_id)
    with open(os.path.join(out_dir, "warmup.fastq"), "wb") as f:
        f.write(fastq_bytes([reads[i] for i in warm],
                            [names[i] for i in warm]))
    info = {"num_reads": len(reads), "bases": int(lens.sum()),
            "longest": int(lens.max()), "longest_id": longest_id,
            "warmup_reads": len(warm),
            "warmup_bases": int(lens[warm].sum()),
            "lengths": lens.tolist()}
    with open(os.path.join(out_dir, "reads.json"), "w") as f:
        json.dump(info, f)
    return info


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="configuration JSON")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True, help="directory to write into")
    ap.add_argument("--warmup-reads", type=int, default=64)
    ap.add_argument("--workers", type=int, default=1)
    a = ap.parse_args()
    with open(a.config) as f:
        cfg = json.load(f)
    write_run(cfg, a.seed, a.out, a.warmup_reads, a.workers)


if __name__ == "__main__":
    main()
