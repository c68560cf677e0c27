// Suffix array of an nsbwt block on the card, and the three things the
// block coder takes from it: the BWT bytes, the primary index and the
// inverse-BWT chain checkpoints.
//
// Replaces no TPU kernel: the JAX package builds every suffix array on
// the host (native/codec.cpp::bwt_forward, SA-IS), and so does the port
// where no card is set. It computes exactly what bwt_forward computes.
// With s[i] = data[i] + 1 for i < n and s[n] = 0 (a unique smallest
// sentinel), SA the suffix array of s and ISA its inverse:
//   out     = data[SA[r] - 1] for every row r with SA[r] != 0, in row order
//   primary = ISA[0]
//   ck[c]   = ISA[n - c * (n / nck)] for c in [1, nck)
// A suffix array is unique for its input, so the coded block is the same
// bytes whichever side built it.
//
// Bound. n bytes in and n bytes out (and nck words): at 3.35 TB/s a
// 32 MB block needs 20 us. The work is in the sorts: prefix doubling
// sorts the suffixes still tied once per doubling, so the time follows
// the block's longest repeat (log2 of it rounds) and how many suffixes
// lie in repeats, not its length alone.
//
// Design (prefix doubling, Manber-Myers ranks, Larsson-Sadakane's
// "sort only what is still tied"):
// * Round 0 ranks every suffix by a 64-bit key: its first 7 bytes,
//   zero-padded, and in the low byte min(length, 7). A suffix shorter
//   than 7 then sorts before every longer one that shares its bytes, as
//   the sentinel makes it, so the key ranks 7-prefixes of s exactly.
// * A rank is the row of the first suffix of its group (the number of
//   suffixes whose h-prefix is smaller), so a suffix that is alone in its
//   group has its final row as its rank. Round r >= 1 sorts the active
//   suffixes (those still tied) by (rank[i], rank[i + h]), h = 7 << (r-1),
//   which ranks their 2h-prefixes; i + h <= n holds for every tied
//   suffix, since an h-prefix that holds the sentinel is unique.
// * The active suffixes are kept in row order beside the rows they
//   occupy (pos), so after a sort the p-th of them sits at row pos[p]: a
//   group's new rank is pos at its first member (an inclusive max-scan of
//   pos at the heads), and the suffixes now alone are dropped by a
//   compaction (an exclusive scan of the keep flags). The loop ends when
//   none is tied; then rank is ISA, and one pass writes the BWT bytes.
// * The sort is an LSD radix sort of (key, suffix) with 8-bit digits
//   over the key's bits (64 in round 0, then twice the bits of n): per
//   digit a histogram per tile, a device-wide scan of the histograms in
//   digit-major order, and a stable scatter in which each warp ranks its
//   elements with __match_any_sync and per-warp counters in shared
//   memory, and the block's warps are laid end to end by a scan over
//   warps. The scans are three launches: tile totals, one block that
//   scans them, and each tile again with its carry.
// * The host reads the number still tied after each round (one 4-byte
//   copy and a synchronise), to size the next round's launches and to
//   stop. Scratch comes from the caller (ns_bwt_sa_scratch_bytes).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RADIX_THREADS = 256;
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int RADIX_ITEMS = 16;
constexpr int RADIX_TILE = RADIX_THREADS * RADIX_ITEMS;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int EW_THREADS = 256;           // one element per thread
constexpr int MAX_ROUNDS = 40;            // h = 7 << 38 passes any block
constexpr int MAX_NCK = 32;

struct AddOp {
    __device__ static uint32_t id() { return 0u; }
    __device__ static uint32_t op(uint32_t a, uint32_t b) { return a + b; }
};
struct MaxOp {
    __device__ static uint32_t id() { return 0u; }
    __device__ static uint32_t op(uint32_t a, uint32_t b) { return a > b ? a : b; }
};

template <class Op>
__device__ __forceinline__ uint32_t warp_inclusive(uint32_t x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x = Op::op(y, x);
    }
    return x;
}

// Exclusive prefix of `agg` over the block's threads in thread order;
// *total gets the block's aggregate. wtot holds 32 words.
template <class Op>
__device__ uint32_t block_exclusive(uint32_t agg, uint32_t* wtot,
                                    uint32_t* total) {
    constexpr int NW = SCAN_THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t incl = warp_inclusive<Op>(agg, lane);
    uint32_t excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = Op::id();
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t t = lane < NW ? wtot[lane] : Op::id();
        t = warp_inclusive<Op>(t, lane);
        wtot[lane] = t;
    }
    __syncthreads();
    const uint32_t pre = warp == 0 ? Op::id() : wtot[warp - 1];
    *total = wtot[NW - 1];
    __syncthreads();
    return Op::op(pre, excl);
}

// This thread's SCAN_ITEMS consecutive words of the tile at `base`.
template <class Op>
__device__ __forceinline__ void load_items(const uint32_t* in, int64_t N,
                                           int64_t base, uint32_t v[4]) {
    const int64_t i = base + int64_t(threadIdx.x) * SCAN_ITEMS;
    if (i + SCAN_ITEMS <= N &&
        (reinterpret_cast<uintptr_t>(in + i) & 15) == 0) {
        const uint4 q = *reinterpret_cast<const uint4*>(in + i);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int j = 0; j < SCAN_ITEMS; ++j)
            v[j] = i + j < N ? in[i + j] : Op::id();
    }
}

template <class Op>
__device__ __forceinline__ uint32_t fold(const uint32_t v[4]) {
    return Op::op(Op::op(v[0], v[1]), Op::op(v[2], v[3]));
}

template <class Op>
__global__ void scan_reduce(const uint32_t* in, int64_t N, uint32_t* parts) {
    __shared__ uint32_t wtot[32];
    uint32_t v[SCAN_ITEMS], total;
    load_items<Op>(in, N, int64_t(blockIdx.x) * SCAN_TILE, v);
    block_exclusive<Op>(fold<Op>(v), wtot, &total);
    if (threadIdx.x == 0) parts[blockIdx.x] = total;
}

// One block: the tile totals, scanned exclusive in place; the grand
// total to *total_out when it is given.
template <class Op>
__global__ void scan_parts(uint32_t* parts, int64_t nb, uint32_t* total_out) {
    __shared__ uint32_t wtot[32];
    uint32_t carry = Op::id();
    for (int64_t base = 0; base < nb; base += SCAN_TILE) {
        uint32_t v[SCAN_ITEMS], total;
        load_items<Op>(parts, nb, base, v);
        uint32_t run = Op::op(carry, block_exclusive<Op>(fold<Op>(v), wtot,
                                                         &total));
        const int64_t i = base + int64_t(threadIdx.x) * SCAN_ITEMS;
#pragma unroll
        for (int j = 0; j < SCAN_ITEMS; ++j) {
            if (i + j < nb) parts[i + j] = run;
            run = Op::op(run, v[j]);
        }
        carry = Op::op(carry, total);
    }
    if (threadIdx.x == 0 && total_out != nullptr) *total_out = carry;
}

template <class Op, bool INCLUSIVE>
__global__ void scan_down(uint32_t* data, int64_t N, const uint32_t* parts) {
    __shared__ uint32_t wtot[32];
    const int64_t base = int64_t(blockIdx.x) * SCAN_TILE;
    uint32_t v[SCAN_ITEMS], total;
    load_items<Op>(data, N, base, v);
    uint32_t run = Op::op(parts[blockIdx.x],
                          block_exclusive<Op>(fold<Op>(v), wtot, &total));
    const int64_t i = base + int64_t(threadIdx.x) * SCAN_ITEMS;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
        const uint32_t next = Op::op(run, v[j]);
        if (i + j < N) data[i + j] = INCLUSIVE ? next : run;
        run = next;
    }
}

template <class Op, bool INCLUSIVE>
cudaError_t scan(uint32_t* data, int64_t N, uint32_t* parts,
                 uint32_t* total_out, cudaStream_t st) {
    const int64_t nb = (N + SCAN_TILE - 1) / SCAN_TILE;
    scan_reduce<Op><<<nb, SCAN_THREADS, 0, st>>>(data, N, parts);
    scan_parts<Op><<<1, SCAN_THREADS, 0, st>>>(parts, nb, total_out);
    scan_down<Op, INCLUSIVE><<<nb, SCAN_THREADS, 0, st>>>(data, N, parts);
    return cudaGetLastError();
}

// Per tile, how many keys hold each value of the digit at `shift`;
// counts is digit-major: counts[d * nblocks + tile].
__global__ void radix_hist(const uint64_t* keys, int64_t m, int shift,
                           uint32_t* counts, int64_t nblocks) {
    __shared__ uint32_t h[256];
    for (int d = threadIdx.x; d < 256; d += RADIX_THREADS) h[d] = 0;
    __syncthreads();
    const int64_t base = int64_t(blockIdx.x) * RADIX_TILE;
#pragma unroll 4
    for (int k = 0; k < RADIX_ITEMS; ++k) {
        const int64_t p = base + k * RADIX_THREADS + threadIdx.x;
        if (p < m) atomicAdd(&h[uint32_t(keys[p] >> shift) & 255u], 1u);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < 256; d += RADIX_THREADS)
        counts[int64_t(d) * nblocks + blockIdx.x] = h[d];
}

// Stable scatter by the digit at `shift`; offs is counts after an
// exclusive scan. Warp w of the block takes the 32 * RADIX_ITEMS keys at
// tile + w * 32 * RADIX_ITEMS in order, 32 at a time.
__global__ void radix_scatter(const uint64_t* kin, const uint32_t* vin,
                              uint64_t* kout, uint32_t* vout, int64_t m,
                              int shift, const uint32_t* offs,
                              int64_t nblocks) {
    __shared__ uint32_t cnt[RADIX_WARPS][256];
    for (int i = threadIdx.x; i < RADIX_WARPS * 256; i += RADIX_THREADS)
        cnt[i / 256][i % 256] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t below = (1u << lane) - 1u;
    const int64_t wbase = int64_t(blockIdx.x) * RADIX_TILE
                          + int64_t(warp) * (32 * RADIX_ITEMS);
    uint64_t k[RADIX_ITEMS];
    uint32_t v[RADIX_ITEMS], r[RADIX_ITEMS];
#pragma unroll
    for (int it = 0; it < RADIX_ITEMS; ++it) {
        const int64_t p = wbase + it * 32 + lane;
        const bool ok = p < m;
        k[it] = ok ? kin[p] : 0;
        v[it] = ok ? vin[p] : 0;
    }
#pragma unroll
    for (int it = 0; it < RADIX_ITEMS; ++it) {
        const bool ok = wbase + it * 32 + lane < m;
        const uint32_t d = ok ? uint32_t(k[it] >> shift) & 255u : 256u;
        const uint32_t peers = __match_any_sync(0xffffffffu, d);
        const uint32_t before = __popc(peers & below);
        const uint32_t c = ok ? cnt[warp][d] : 0u;
        r[it] = c + before;
        __syncwarp();
        if (ok && before == 0) cnt[warp][d] = c + __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    {   // per digit, the block's warps end to end
        const int d = threadIdx.x;
        uint32_t run = 0;
        for (int w = 0; w < RADIX_WARPS; ++w) {
            const uint32_t c = cnt[w][d];
            cnt[w][d] = run;
            run += c;
        }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < RADIX_ITEMS; ++it) {
        const int64_t p = wbase + it * 32 + lane;
        if (p < m) {
            const uint32_t d = uint32_t(k[it] >> shift) & 255u;
            const uint32_t at = offs[int64_t(d) * nblocks + blockIdx.x]
                                + cnt[warp][d] + r[it];
            kout[at] = k[it];
            vout[at] = v[it];
        }
    }
}

__device__ __forceinline__ int64_t elem() {
    return int64_t(blockIdx.x) * EW_THREADS + threadIdx.x;
}

__global__ void init_keys(const uint8_t* data, int64_t n, uint64_t* keys,
                          uint32_t* idx, uint32_t* pos) {
    const int64_t i = elem();
    if (i > n) return;
    uint64_t k = 0;
#pragma unroll
    for (int j = 0; j < 7; ++j) k = (k << 8) | (i + j < n ? data[i + j] : 0u);
    const int64_t len = n - i;
    keys[i] = (k << 8) | uint64_t(len < 7 ? len : 7);
    idx[i] = uint32_t(i);
    pos[i] = uint32_t(i);
}

__global__ void pair_keys(const uint32_t* idx, int64_t m, const uint32_t* rank,
                          int64_t h, int rb, uint64_t* keys) {
    const int64_t p = elem();
    if (p >= m) return;
    const uint32_t i = idx[p];
    keys[p] = (uint64_t(rank[i]) << rb) | rank[i + h];
}

__device__ __forceinline__ bool alone(const uint64_t* keys, int64_t p,
                                      int64_t m) {
    const uint64_t k = keys[p];
    return (p == 0 || keys[p - 1] != k) && (p == m - 1 || keys[p + 1] != k);
}

// The row of each group's first member at its head, 0 elsewhere.
__global__ void heads(const uint64_t* keys, int64_t m, const uint32_t* pos,
                      uint32_t* out) {
    const int64_t p = elem();
    if (p >= m) return;
    out[p] = (p == 0 || keys[p - 1] != keys[p]) ? pos[p] : 0u;
}

__global__ void settle(const uint64_t* keys, const uint32_t* idx, int64_t m,
                       const uint32_t* newrank, uint32_t* rank,
                       uint32_t* keep) {
    const int64_t p = elem();
    if (p >= m) return;
    rank[idx[p]] = newrank[p];
    keep[p] = alone(keys, p, m) ? 0u : 1u;
}

__global__ void compact(const uint64_t* keys, const uint32_t* idx,
                        const uint32_t* pos, int64_t m, const uint32_t* dst,
                        uint32_t* idx_out, uint32_t* pos_out) {
    const int64_t p = elem();
    if (p >= m || alone(keys, p, m)) return;
    idx_out[dst[p]] = idx[p];
    pos_out[dst[p]] = pos[p];
}

__global__ void gather_bwt(const uint8_t* data, int64_t n,
                           const uint32_t* isa, uint8_t* out) {
    const int64_t i = elem() + 1;
    if (i > n) return;
    const uint32_t primary = isa[0];
    const uint32_t r = isa[i];
    out[r - (r > primary ? 1u : 0u)] = data[i - 1];
}

__global__ void gather_info(const uint32_t* isa, int64_t n, int nck,
                            uint32_t* info) {
    const int c = threadIdx.x;
    if (c == 0) info[0] = isa[0];
    else if (c < nck) info[c] = isa[n - int64_t(c) * (n / nck)];
}

struct Scratch {
    uint64_t* keys[2];
    uint32_t* idx[2];
    uint32_t* pos[2];
    uint32_t *rank, *t0, *t1, *counts, *parts, *total;
};

int64_t carve(uint8_t* base, int64_t n, Scratch* s) {
    const int64_t m = n + 1;
    const int64_t tiles = (m + RADIX_TILE - 1) / RADIX_TILE;
    const int64_t scanned = m > 256 * tiles ? m : 256 * tiles;
    int64_t off = 0;
    auto take = [&](int64_t bytes) {
        uint8_t* p = base ? base + off : nullptr;
        off += (bytes + 255) / 256 * 256;
        return p;
    };
    for (int b = 0; b < 2; ++b) {
        s->keys[b] = reinterpret_cast<uint64_t*>(take(8 * m));
        s->idx[b] = reinterpret_cast<uint32_t*>(take(4 * m));
        s->pos[b] = reinterpret_cast<uint32_t*>(take(4 * m));
    }
    s->rank = reinterpret_cast<uint32_t*>(take(4 * m));
    s->t0 = reinterpret_cast<uint32_t*>(take(4 * m));
    s->t1 = reinterpret_cast<uint32_t*>(take(4 * m));
    s->counts = reinterpret_cast<uint32_t*>(take(4 * 256 * tiles));
    s->parts = reinterpret_cast<uint32_t*>(
        take(4 * ((scanned + SCAN_TILE - 1) / SCAN_TILE + 1)));
    s->total = reinterpret_cast<uint32_t*>(take(4));
    return off;
}

int64_t blocks(int64_t m) { return (m + EW_THREADS - 1) / EW_THREADS; }

// LSD radix sort of (keys[cur], idx[cur]) over the low `bits` bits; cur
// names the buffers that hold the result.
cudaError_t radix_sort(Scratch& s, int& cur, int64_t m, int bits,
                       cudaStream_t st) {
    const int64_t tiles = (m + RADIX_TILE - 1) / RADIX_TILE;
    for (int shift = 0; shift < bits; shift += 8) {
        radix_hist<<<tiles, RADIX_THREADS, 0, st>>>(s.keys[cur], m, shift,
                                                    s.counts, tiles);
        const cudaError_t e = scan<AddOp, false>(s.counts, 256 * tiles,
                                                 s.parts, nullptr, st);
        if (e != cudaSuccess) return e;
        radix_scatter<<<tiles, RADIX_THREADS, 0, st>>>(
            s.keys[cur], s.idx[cur], s.keys[1 - cur], s.idx[1 - cur], m,
            shift, s.counts, tiles);
        cur = 1 - cur;
    }
    return cudaGetLastError();
}

}  // namespace

// Device bytes of scratch that ns_bwt_sa_launch takes for an n-byte block.
extern "C" int64_t ns_bwt_sa_scratch_bytes(int64_t n) {
    Scratch s;
    return carve(nullptr, n, &s);
}

// The BWT of data[0..n) (device pointers, 1 <= n < 2^31, 1 <= nck <= 32)
// into out[0..n), and info[0] = primary, info[c] = ck[c] for c in
// [1, nck). Synchronises `stream` once a round.
extern "C" int ns_bwt_sa_launch(const void* data, int64_t n, int nck,
                                void* out, void* info, void* scratch,
                                int64_t scratch_bytes, void* stream) {
    if (n < 1 || n >= (int64_t(1) << 31) || nck < 1 || nck > MAX_NCK)
        return (int)cudaErrorInvalidValue;
    Scratch s;
    if (carve(static_cast<uint8_t*>(scratch), n, &s) > scratch_bytes)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* d = static_cast<const uint8_t*>(data);
    int64_t m = n + 1;
    const int rb = 64 - __builtin_clzll(uint64_t(n));   // bits of a rank
    int cur = 0, r = 0, bits = 64;
    init_keys<<<blocks(m), EW_THREADS, 0, st>>>(d, n, s.keys[0], s.idx[0],
                                                s.pos[0]);
    int pcur = 0;
    for (;;) {
        cudaError_t e = radix_sort(s, cur, m, bits, st);
        if (e != cudaSuccess) return (int)e;
        const uint64_t* keys = s.keys[cur];
        heads<<<blocks(m), EW_THREADS, 0, st>>>(keys, m, s.pos[pcur], s.t0);
        if ((e = scan<MaxOp, true>(s.t0, m, s.parts, nullptr, st)) != cudaSuccess)
            return (int)e;
        settle<<<blocks(m), EW_THREADS, 0, st>>>(keys, s.idx[cur], m, s.t0,
                                                 s.rank, s.t1);
        if ((e = scan<AddOp, false>(s.t1, m, s.parts, s.total, st)) != cudaSuccess)
            return (int)e;
        compact<<<blocks(m), EW_THREADS, 0, st>>>(
            keys, s.idx[cur], s.pos[pcur], m, s.t1, s.idx[1 - cur],
            s.pos[1 - pcur]);
        cur = 1 - cur;
        pcur = 1 - pcur;
        uint32_t left = 0;
        e = cudaMemcpyAsync(&left, s.total, 4, cudaMemcpyDeviceToHost, st);
        if (e == cudaSuccess) e = cudaStreamSynchronize(st);
        if (e != cudaSuccess) return (int)e;
        ++r;
        m = left;
        if (m == 0) break;
        if (r >= MAX_ROUNDS) return (int)cudaErrorUnknown;
        bits = 2 * rb;
        pair_keys<<<blocks(m), EW_THREADS, 0, st>>>(
            s.idx[cur], m, s.rank, int64_t(7) << (r - 1), rb, s.keys[cur]);
    }
    gather_bwt<<<blocks(n), EW_THREADS, 0, st>>>(d, n, s.rank,
                                                 static_cast<uint8_t*>(out));
    gather_info<<<1, MAX_NCK, 0, st>>>(s.rank, n, nck,
                                       static_cast<uint32_t*>(info));
    return (int)cudaGetLastError();
}
