// MinHash sketch of every read of a 2-bit packed store, on the card.
//
// Replaces nanospring_tpu/ops/sketch.py::sketch_batch_packed /
// sketch_batch (jitted XLA, :110-153), and computes the same bits as
// native/sketch.cpp::ns_sketch_reads:
//   canonical k-mer v = min(fwd, revcomp) as a 2k-bit integer, 16 < k <= 32
//   lo, hi = low / high 32 bits of v
//   y = fmix32(lo);  z = fmix32(hi ^ y)           (mixed once per k-mer)
//   h_j = y * (seed_lo[j] | 1) + z * (seed_hi[j] | 1)   mod 2^32
//   sketch[j] = min over positions p <= len - k of h_j
// Reads shorter than max(k, min_len) get EMPTY (0xFFFFFFFF) in every slot.
//
// Bound. The per-seed fold is the work: a multiply, a multiply-add and a
// minimum per (k-mer, seed) against a few bytes per read: operations
// bound. An SM runs 32-bit multiplies on 64 lanes per clock and the
// minima in another pipe beside them, so the least time is that of the
// multiplies: 2 x k-mers x seeds over SMs x 64 x clock. Everything below
// serves one aim: per (k-mer, seed) the card does that fold and little
// else.
//
// Design.
// * Work. The output is set to EMPTY, then one launch of an
//   (n_reads, SPLIT) grid: block (r, y) takes tiles y, y + SPLIT, ... of
//   read r (TILE k-mer positions each) and leaves at once when the read is
//   too short or has no such tile, so a long read is shared by up to SPLIT
//   blocks and a short read costs one. Blocks of one read meet by
//   atomicMin on the read's output row; unsigned minima commute, so the
//   bits do not depend on the order.
// * k-mers from the packed words. The store is packed LSB first, so the
//   2k bits at bit 2p of a read's stream are sum(c_j << 2j): their
//   complement under the 2k-bit mask is the reverse complement, and the
//   forward k-mer is the same window with its 2-bit groups reversed. A
//   tile's bytes (only bytes of the read itself, so nothing past the store
//   is touched) are staged in shared memory; each thread then takes RUN
//   consecutive positions: three funnel shifts align 96 bits of the stream
//   to its first base, every later window is two funnel shifts, the first
//   forward k-mer is one __brevll and a swap of the bits of each pair, and
//   the following ones shift in one base. There is no loop over k.
// * Seed lanes that all work. A warp lies across the seeds, S =
//   ceil(n_seeds / 32) per lane (a template parameter, 1..8), and the
//   block's warps take a tile's groups of four positions in turn. A warp
//   reads four positions' (y, z) with two 16-byte broadcast loads and folds
//   them into S running minima per lane with three-input minima; the loop
//   is unrolled so that the next groups' loads are in flight under the
//   4 x S independent products. The minima meet in shared memory once per
//   block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 16;                   // consecutive positions per thread
constexpr int TILE = THREADS * RUN;       // k-mer positions per tile
constexpr int STAGE_WORDS = TILE / 16 + 4;  // a tile's bases + k - 1, + slack
constexpr int SPLIT = 4;                  // blocks sharing a long read
constexpr int UNROLL = 2;                 // groups of 4 positions per step
constexpr int MAX_S = 8;                  // seeds per lane
constexpr int MAX_SEEDS = 32 * MAX_S;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

static_assert(RUN % 4 == 0 && RUN <= 16,
              "a run starts on a byte and its windows fit in 96 bits");
static_assert(MAX_SEEDS <= THREADS, "one thread per output slot");

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// sum(c_j << 2j) -> sum(c_j << 2(k-1-j)) for a window already masked to 2k
// bits: reverse the bits, put the two bits of each pair back in order, and
// drop the 64 - 2k low zeros.
__device__ __forceinline__ uint64_t reverse_groups(uint64_t w, int k) {
    const uint64_t r = __brevll(w);
    const uint64_t odd = 0x5555555555555555ull;
    return (((r & odd) << 1) | ((r >> 1) & odd)) >> (64 - 2 * k);
}

template <int S>
__global__ void __launch_bounds__(THREADS)
sketch_kernel(const uint8_t* __restrict__ packed,
              const int64_t* __restrict__ offsets,
              const int64_t* __restrict__ lengths,
              const int64_t* __restrict__ seeds,   // (n, 2): lo, hi
              int n_seeds, int k, int64_t min_len,
              uint32_t* __restrict__ out)          // (N, n), EMPTY on entry
{
    __shared__ __align__(16) uint32_t sy[TILE];
    __shared__ __align__(16) uint32_t sz[TILE];
    __shared__ uint32_t stage[STAGE_WORDS];
    __shared__ uint32_t smin[MAX_SEEDS];

    const int64_t r = blockIdx.x;
    const int64_t len = lengths[r];
    if (len < min_len || len < k) return;          // the row stays EMPTY
    const int64_t P = len - k + 1;
    const int64_t n_tiles = (P + TILE - 1) / TILE;
    if ((int64_t)blockIdx.y >= n_tiles) return;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < MAX_SEEDS) smin[tid] = EMPTY;
    uint32_t a[S], b[S], best[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int j = lane + 32 * s;
        a[s] = j < n_seeds ? ((uint32_t)seeds[2 * j] | 1u) : 1u;
        b[s] = j < n_seeds ? ((uint32_t)seeds[2 * j + 1] | 1u) : 1u;
        best[s] = EMPTY;
    }

    const uint8_t* src = packed + offsets[r];
    const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const int top = 2 * k - 2;                     // a window's last base
    uint8_t* stage_bytes = reinterpret_cast<uint8_t*>(stage);

    for (int64_t tile = blockIdx.y; tile < n_tiles; tile += SPLIT) {
        const int64_t t0 = tile * TILE;            // a multiple of 4 bases
        const int cnt = (int)((P - t0) < TILE ? (P - t0) : TILE);
        // bytes holding the tile's cnt + k - 1 bases: all inside the read
        const int nb = (cnt + k + 2) >> 2;
        const uint8_t* g = src + (t0 >> 2);
        for (int i = tid; i < nb; i += THREADS) stage_bytes[i] = g[i];
        __syncthreads();

        // k-mers and their mix: RUN consecutive positions per thread. Bits
        // past the staged bytes are arbitrary; they reach only positions
        // >= cnt, which the fold never reads.
        const int p0 = tid * RUN;
        if (p0 < cnt) {
            const int byte0 = p0 >> 2;
            const int wi = byte0 >> 2;
            const int sh = (byte0 & 3) * 8;
            const uint32_t w0 = stage[wi], w1 = stage[wi + 1];
            const uint32_t w2 = stage[wi + 2], w3 = stage[wi + 3];
            const uint32_t x0 = __funnelshift_r(w0, w1, sh);
            const uint32_t x1 = __funnelshift_r(w1, w2, sh);
            const uint32_t x2 = __funnelshift_r(w2, w3, sh);
            uint32_t ys[RUN], zs[RUN];
            uint64_t fwd = 0;
#pragma unroll
            for (int i = 0; i < RUN; ++i) {
                const uint64_t w =
                    (((uint64_t)__funnelshift_r(x1, x2, 2 * i) << 32)
                     | __funnelshift_r(x0, x1, 2 * i)) & mask;
                const uint64_t rc = w ^ mask;
                fwd = i == 0 ? reverse_groups(w, k)
                             : (((fwd << 2) | (w >> top)) & mask);
                const uint64_t v = fwd < rc ? fwd : rc;
                ys[i] = fmix32((uint32_t)v);
                zs[i] = fmix32((uint32_t)(v >> 32) ^ ys[i]);
            }
#pragma unroll
            for (int i = 0; i < RUN; i += 4) {
                *reinterpret_cast<uint4*>(&sy[p0 + i]) =
                    make_uint4(ys[i], ys[i + 1], ys[i + 2], ys[i + 3]);
                *reinterpret_cast<uint4*>(&sz[p0 + i]) =
                    make_uint4(zs[i], zs[i + 1], zs[i + 2], zs[i + 3]);
            }
        }
        __syncthreads();

        // fold: the warps take the tile's groups of four positions in turn
        const int full = cnt & ~3;
#pragma unroll UNROLL
        for (int x = 4 * warp; x < full; x += 4 * WARPS) {
            const uint4 y = *reinterpret_cast<const uint4*>(&sy[x]);
            const uint4 z = *reinterpret_cast<const uint4*>(&sz[x]);
#pragma unroll
            for (int s = 0; s < S; ++s) {
                // three-input minima (VIMNMX3): two per four positions
                best[s] = min(min(best[s], y.x * a[s] + z.x * b[s]),
                              y.y * a[s] + z.y * b[s]);
                best[s] = min(min(best[s], y.z * a[s] + z.z * b[s]),
                              y.w * a[s] + z.w * b[s]);
            }
        }
        for (int x = full + warp; x < cnt; x += WARPS) {
            const uint32_t y = sy[x];
            const uint32_t z = sz[x];
#pragma unroll
            for (int s = 0; s < S; ++s)
                best[s] = min(best[s], y * a[s] + z * b[s]);
        }
        // the next tile's k-mers are written only after its staging
        // barrier, which every warp reaches after this fold
    }

#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int j = lane + 32 * s;
        if (j < n_seeds) atomicMin(&smin[j], best[s]);
    }
    __syncthreads();
    if (tid < n_seeds) atomicMin(out + r * (int64_t)n_seeds + tid, smin[tid]);
}

template <int S>
void launch(const void* packed, const void* offsets, const void* lengths,
            const void* seeds, int64_t n_reads, int n_seeds, int k,
            int64_t min_len, void* out, cudaStream_t stream)
{
    sketch_kernel<S><<<dim3((unsigned)n_reads, SPLIT), THREADS, 0, stream>>>(
        (const uint8_t*)packed, (const int64_t*)offsets,
        (const int64_t*)lengths, (const int64_t*)seeds, n_seeds, k, min_len,
        (uint32_t*)out);
}

}  // namespace

extern "C" int ns_sketch_launch(
    const void* packed, const void* offsets, const void* lengths,
    const void* seeds, int64_t n_reads, int n_seeds, int k,
    int64_t min_len, void* out, void* stream)
{
    if (n_reads <= 0) return 0;
    if (n_seeds <= 0 || n_seeds > MAX_SEEDS || k <= 16 || k > 32)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e = cudaMemsetAsync(
        out, 0xFF, (size_t)n_reads * (size_t)n_seeds * sizeof(uint32_t), st);
    if (e != cudaSuccess) return (int)e;
#define NS_SKETCH_CASE(S)                                                   \
    case S:                                                                 \
        launch<S>(packed, offsets, lengths, seeds, n_reads, n_seeds, k,     \
                  min_len, out, st);                                        \
        break;
    switch ((n_seeds + 31) / 32) {
        NS_SKETCH_CASE(1) NS_SKETCH_CASE(2) NS_SKETCH_CASE(3)
        NS_SKETCH_CASE(4) NS_SKETCH_CASE(5) NS_SKETCH_CASE(6)
        NS_SKETCH_CASE(7) NS_SKETCH_CASE(8)
    }
#undef NS_SKETCH_CASE
    return (int)cudaGetLastError();
}
