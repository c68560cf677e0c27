"""Archive container: one ``.nstpu`` file = meta + coded streams.

The reference tars per-stream files + metaData by shelling out to /bin/tar
(reference: src/Compressor.cpp:146-153, src/Decompressor.cpp:32-41). A tar
costs 512 B per member header, 512 B block rounding per member, and a
10 KiB end-of-archive pad — pure ratio loss on small archives — so the
native container here is a minimal length-prefixed concat:

    magic "NSTPU1\\n" | u64 meta_len | meta JSON |
    repeat: u8 name_len | name | u64 data_len | data

meta is JSON carrying the counts the decompressor needs (the reference's
key=value metaData, src/Consensus.cpp:374-385) plus the codec per stream.
``read_archive`` still reads the old tar layout for archives written before
this format.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import struct
import zlib

import numpy as np

from ..codec import backends
from ..utils import observe
from . import streams as st

FORMAT_VERSION = 2
_MAGIC = b"NSTPU1\n"
_META_NAME = "meta.json"


def write_archive(
    out_path: str,
    stream_set: st.StreamSet,
    meta: dict,
    codec_map: dict[str, str],
    pool: cf.Executor | None = None,
    device=None,
) -> dict[str, int]:
    """Compress each stream with its codec and concatenate everything.

    With ``device`` a card, the nsbwt blocks' suffix arrays are built there
    (``backends.card_suffix_sort``; the same bytes).
    Returns the compressed size per stream (for observability/ratio stats).
    Traced on the current tracer: ``archive.crc`` and ``archive.write`` on
    the calling thread, a ``codec.<stream>`` span per chunk job on the
    pool's threads (its codec, bytes in and bytes out) with a
    ``codec.sa_card`` span inside for each block sorted on the card, and
    the counters ``codec_chunk_s`` (the chunk jobs' summed seconds),
    ``codec_longest_chunk_s`` (the slowest one), ``bwt_card_bytes`` and
    ``bwt_host_bytes`` (the nsbwt bytes suffix-sorted on each side).
    """
    tr = observe.current()
    meta = dict(meta)
    meta["format_version"] = FORMAT_VERSION
    meta["codecs"] = codec_map
    # per-stream CRC32 of the raw bytes: corruption surfaces as a named
    # error instead of silent garbage (the role of libbsc's per-block
    # adler32 in the reference, libbsc/adler32/)
    def _crc(data) -> int:
        if isinstance(data, (bytes, bytearray, memoryview)):
            return zlib.crc32(data)
        return zlib.crc32(memoryview(np.ascontiguousarray(data)))

    with tr.stage("archive.crc"):
        meta["crc32"] = {n: _crc(stream_set.get(n))
                         for n in st.STREAM_NAMES}
    sizes: dict[str, int] = {}

    # flatten (stream, chunk) jobs so one pool parallelizes both across
    # streams and within big streams (the reference parallelizes only at
    # the file level, src/Compressor.cpp:121-134)
    chunked = {n: backends.split_chunks(stream_set.get(n))
               for n in st.STREAM_NAMES}
    jobs = [(n, i, ch) for n, chs in chunked.items()
            for i, ch in enumerate(chs)]
    jobs.sort(key=lambda t: -len(t[2]))  # big chunks first: better packing

    def _job(t):
        n, i, ch = t
        with tr.stage("codec." + n):
            p = backends.compress_chunk(codec_map[n], ch)
            tr.note(codec=codec_map[n], bytes_in=len(ch), bytes_out=len(p))
        span = tr.last()
        dt = span["end"] - span["start"]
        tr.add("codec_chunk_s", dt)
        tr.peak("codec_longest_chunk_s", dt)
        return n, i, p

    with backends.card_suffix_sort(device):
        results = list(pool.map(_job, jobs)) if pool is not None else [
            _job(t) for t in jobs
        ]
    coded = {}
    for n, chs in chunked.items():
        payloads = [None] * len(chs)
        for rn, ri, p in results:
            if rn == n:
                payloads[ri] = p
        coded[n] = backends.assemble_chunks(payloads)

    with tr.stage("archive.write"), open(out_path, "wb") as f:
        f.write(_MAGIC)
        mbytes = json.dumps(meta, indent=0).encode()
        f.write(struct.pack("<Q", len(mbytes)))
        f.write(mbytes)
        for name in st.STREAM_NAMES:
            data = coded[name]
            sizes[name] = len(data)
            nb = name.encode()
            f.write(struct.pack("<B", len(nb)))
            f.write(nb)
            f.write(struct.pack("<Q", len(data)))
            f.write(data)
    return sizes


def _read_native(path: str) -> tuple[dict, dict[str, bytes]]:
    import os

    total = os.path.getsize(path)
    with open(path, "rb") as f:
        assert f.read(len(_MAGIC)) == _MAGIC
        (mlen,) = struct.unpack("<Q", f.read(8))
        if mlen > total:
            raise ValueError("archive meta length exceeds the file size — "
                             "the archive is corrupt")
        meta = json.loads(f.read(mlen))
        coded: dict[str, bytes] = {}
        while True:
            nl = f.read(1)
            if not nl:
                break
            name = f.read(nl[0]).decode()
            (dlen,) = struct.unpack("<Q", f.read(8))
            if dlen > total - f.tell():
                # a flipped bit in a length prefix must surface as a
                # named corruption error, not an allocation attempt
                raise ValueError(
                    f"archive stream '{name}' claims {dlen} bytes but only "
                    f"{total - f.tell()} remain — the archive is corrupt")
            coded[name] = f.read(dlen)
    return meta, coded


def _read_tar(path: str) -> tuple[dict, dict[str, bytes]]:
    import tarfile

    with tarfile.open(path, "r") as tar:
        meta = json.loads(tar.extractfile(_META_NAME).read())
        names = tar.getnames()
        coded = {
            name: tar.extractfile(name).read()
            for name in st.STREAM_NAMES
            if name in names
        }
    return meta, coded


def read_archive(
    path: str, pool: cf.Executor | None = None
) -> tuple[dict, dict[str, np.ndarray]]:
    """Returns (meta, {stream name -> raw uint8 array})."""
    with open(path, "rb") as f:
        is_native = f.read(len(_MAGIC)) == _MAGIC
    meta, coded = _read_native(path) if is_native else _read_tar(path)
    codec_map = meta["codecs"]

    # flatten (stream, chunk) decode jobs across the pool (see write side)
    try:
        chunked = {n: backends.split_payloads(d) for n, d in coded.items()}
    except Exception as e:
        raise ValueError(f"archive framing failed to parse — the archive "
                         f"is corrupt ({e})") from e
    jobs = [(n, i, p) for n, ps in chunked.items() for i, p in enumerate(ps)]
    jobs.sort(key=lambda t: -len(t[2]))

    def _job(t):
        n, i, p = t
        return n, i, backends.decompress_chunk(codec_map[n], p)

    try:
        results = list(pool.map(_job, jobs)) if pool is not None else [
            _job(t) for t in jobs
        ]
    except Exception as e:
        # framing/codec errors from flipped bits inside a payload surface
        # before the CRC can run — name them for what they are
        raise ValueError(f"archive payload failed to decode — the archive "
                         f"is corrupt ({e})") from e
    out = {}
    crcs = meta.get("crc32", {})
    for n, ps in chunked.items():
        parts = [None] * len(ps)
        for rn, ri, p in results:
            if rn == n:
                parts[ri] = p
        raw = b"".join(parts)
        if n in crcs and zlib.crc32(raw) != crcs[n]:
            raise ValueError(
                f"archive stream '{n}' failed its CRC32 check: "
                f"the archive is corrupt")
        out[n] = np.frombuffer(raw, dtype=np.uint8)
    return meta, out
