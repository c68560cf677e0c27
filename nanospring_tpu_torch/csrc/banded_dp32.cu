// Banded glocal DP with 256 band slots, int32 costs and one int32 record
// per query row: the Python wavefront's batch DP.
//
// Replaces the v1 Pallas kernel _kernel of nanospring_tpu/ops/align_tpu.py
// (:60, pallas_call in _align_padded at :217), which runs 8 pairs per grid
// program as one (8, 256) int32 block. Its 8,192-row cap (M_PAD_MAX) is the
// TPU's VMEM limit and is not carried over: the direction codes live in
// device memory here, so one kernel takes every row count up to the
// wrapper's 131,072.
//
// The function (per pair: d0, m = query length, n = target length, maxc):
//   slot k in [0, 256) <-> target column j = d0 + i + k - 128; columns
//   outside [0, n] are invalid (slot 0 is valid). tpad[x] = t[x + d0 - 129],
//   so the target base of slot k in row i is tpad[i + k].
//   row 0:  prev[k] = 0 on valid slots, INF = 1 << 30 elsewhere.
//   row i:  diag = prev[k] + (t[j-1] != q[i-1])   (1 <= j <= n, prev < INF)
//           up   = prev[k+1] + 1                  (k < 255, prev < INF)
//           base = min(diag, up) on valid slots, INF elsewhere
//           cur  = min(base, k + prefixmin_k'<=k(base[k'] - k'))   (left)
//           code = cur == diag ? (match ? 4 : 0) : cur == up ? 1 : 2,
//                  and 3 where cur >= INF.
//   best = min over valid final slots (invalid = INF), best_k its lowest
//   slot; the pair is rejected (cost -1) when best > maxc.
//   Traceback from kk = best_k, rows m..1: kp = highest slot <= kk whose
//   code is not left (-1 if none); dels = kk - kp; the record is
//   dels + (optype << 16) + (match << 18) in int32, with optype 3 and match
//   -1 where kp = -1; next kk = kp + (optype == 1). ops_len = m + sum of
//   dels, tstart = d0 + kk_final - 128, tend = d0 + m + best_k - 128.
//   Rejected pairs get records of 0.
//
// Design. One warp per pair, 8 slots per lane. A row is one pass over the
// lane's 8 slots, an up-neighbour __shfl_down_sync, and a prefix-min of
// (base - k) across lanes with __shfl_up_sync. The 8 direction codes of a
// lane (3 bits each, in 4-bit fields) go to device memory as one 32-bit
// word, so a row is one coalesced 128-byte store; the scratch is sized by
// the wrapper to the batch's own longest query. The traceback reads a row
// back, finds kp with one __reduce_max_sync over the lanes' highest
// qualifying slots and fetches its code with __shfl_sync; each lane keeps
// one of 32 consecutive records, stored together as one 128-byte write.
//
// Bound. The row recurrence is a dependent chain (each row needs the whole
// previous row and a warp-wide scan), so a warp is latency bound and a
// launch costs its longest query's rows; the wavefront's batches hold ~90
// pairs, i.e. ~90 warps on 132 SMs. The inputs and records are a few bytes
// per row, and the operations bound (about 8 integer operations per cell)
// is far below what the chain allows. Staging target windows in shared
// memory and several pairs per warp are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KOFF = 128;
constexpr int W = 256;              // band slots
constexpr int SPL = 8;              // slots per lane
constexpr int INF = 1 << 30;
constexpr int NONE = 0x7FFFFFFF;    // empty scan carry / final minimum
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
banded_dp32_kernel(const int32_t* __restrict__ d0s,
                   const int32_t* __restrict__ qlens,
                   const int32_t* __restrict__ tlens,
                   const int32_t* __restrict__ maxcs,
                   const uint8_t* __restrict__ tpad, int64_t t_stride,
                   const uint8_t* __restrict__ qbuf, int64_t q_stride,
                   int32_t* __restrict__ cost_out,
                   int32_t* __restrict__ len_out,
                   int32_t* __restrict__ ts_out,
                   int32_t* __restrict__ te_out,
                   int32_t* __restrict__ trace, int64_t tr_stride,
                   uint32_t* __restrict__ dirs, int64_t dirs_rows,
                   int n_pairs)
{
    const int pair = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (pair >= n_pairs) return;
    const int m = qlens[pair];
    if (m <= 0) {                    // padding pair: nothing to align
        if (lane == 0) {
            cost_out[pair] = 0; len_out[pair] = 0;
            ts_out[pair] = 0; te_out[pair] = 0;
        }
        return;
    }
    const int d0 = d0s[pair];
    const int n = tlens[pair];
    const int maxc = maxcs[pair];
    const uint8_t* t = tpad + (int64_t)pair * t_stride;
    const uint8_t* q = qbuf + (int64_t)pair * q_stride;
    uint32_t* dir = dirs + (int64_t)pair * dirs_rows * 32;
    int32_t* tr = trace + (int64_t)pair * tr_stride;
    const int k0 = SPL * lane;

    int prev[SPL];
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
        const int j0 = d0 + k0 + r - KOFF;
        prev[r] = (j0 >= 0 && j0 <= n) ? 0 : INF;
    }

    for (int i = 1; i <= m; ++i) {
        const int qc = q[i - 1];
        const int nxt = __shfl_down_sync(FULL, prev[0], 1);
        int diag[SPL], up[SPL], base[SPL], x[SPL];
        bool match[SPL], jval[SPL];
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
            const int k = k0 + r;
            const int j = d0 + i + k - KOFF;
            jval[r] = j >= 0 && j <= n;
            const bool dval = j >= 1 && j <= n;
            match[r] = t[i + k] == qc;
            diag[r] = (dval && prev[r] < INF) ? prev[r] + (match[r] ? 0 : 1)
                                              : INF;
            const int u = r < SPL - 1 ? prev[r + 1] : nxt;
            up[r] = (k < W - 1 && u < INF) ? u + 1 : INF;
            base[r] = jval[r] ? min(diag[r], up[r]) : INF;
            x[r] = base[r] - k;
            if (r > 0) x[r] = min(x[r], x[r - 1]);
        }
        // inclusive scan of the lane minima, then the exclusive carry-in
        int tot = x[SPL - 1];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(FULL, tot, off);
            if (lane >= off) tot = min(tot, v);
        }
        int carry = __shfl_up_sync(FULL, tot, 1);
        if (lane == 0) carry = NONE;
        uint32_t codes = 0;
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
            const int left = min(x[r], carry) + k0 + r;
            const int cur = jval[r] ? min(base[r], left) : INF;
            int d = cur == diag[r] ? (match[r] ? 4 : 0)
                                   : (cur == up[r] ? 1 : 2);
            if (cur >= INF) d = 3;
            codes |= (uint32_t)d << (4 * r);
            prev[r] = cur;
        }
        dir[(int64_t)(i - 1) * 32 + lane] = codes;
    }

    int bl = NONE, bkl = W;
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
        const int jm = d0 + m + k0 + r - KOFF;
        const int f = (jm >= 0 && jm <= n) ? prev[r] : INF;
        if (f < bl) { bl = f; bkl = k0 + r; }
    }
    const int best = __reduce_min_sync(FULL, bl);
    const int best_k = __reduce_min_sync(FULL, bl == best ? bkl : W);

    if (best > maxc) {               // rejected: cost -1, records of 0
        for (int i = lane; i < m; i += 32) tr[i] = 0;
        if (lane == 0) {
            cost_out[pair] = -1; len_out[pair] = 0;
            ts_out[pair] = 0; te_out[pair] = 0;
        }
        return;
    }

    int kk = best_k;
    int ndel = 0;
    int32_t held = 0;                // this lane's record of the 32-row group
    for (int i = m; i >= 1; --i) {
        const uint32_t codes = dir[(int64_t)(i - 1) * 32 + lane];
        int lkp = -1;
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
            const uint32_t d = (codes >> (4 * r)) & 7u;
            if ((d & 3u) != 2u && k0 + r <= kk) lkp = k0 + r;
        }
        const int kp = __reduce_max_sync(FULL, lkp);
        const uint32_t src = __shfl_sync(FULL, codes, kp >= 0 ? kp >> 3 : 0);
        const int dv = kp >= 0 ? (int)((src >> (4 * (kp & 7))) & 7u) : -1;
        const int optype = dv < 0 ? 3 : (dv & 3);
        const int mbit = dv < 0 ? -1 : (dv >> 2);
        const int dels = kk - kp;
        const int rec = dels + optype * (1 << 16) + mbit * (1 << 18);
        const int row = i - 1;
        if (lane == (row & 31)) held = rec;
        if ((row & 31) == 0 && row + lane < m) tr[row + lane] = held;
        kk = kp + (optype == 1 ? 1 : 0);
        ndel += dels;
    }
    if (lane == 0) {
        cost_out[pair] = best;
        len_out[pair] = m + ndel;
        ts_out[pair] = d0 + kk - KOFF;
        te_out[pair] = d0 + m + best_k - KOFF;
    }
}

}  // namespace

extern "C" int ns_banded_dp32_launch(
    const void* d0, const void* qlen, const void* tlen, const void* maxc,
    const void* tpad, int64_t t_stride, const void* qbuf, int64_t q_stride,
    void* cost, void* ops_len, void* ts, void* te,
    void* trace, int64_t tr_stride, void* dirs, int64_t dirs_rows,
    int n_pairs, void* stream)
{
    if (n_pairs <= 0) return 0;
    const int blocks = (n_pairs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    banded_dp32_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)d0, (const int32_t*)qlen, (const int32_t*)tlen,
        (const int32_t*)maxc, (const uint8_t*)tpad, t_stride,
        (const uint8_t*)qbuf, q_stride, (int32_t*)cost, (int32_t*)ops_len,
        (int32_t*)ts, (int32_t*)te, (int32_t*)trace, tr_stride,
        (uint32_t*)dirs, dirs_rows, n_pairs);
    return (int)cudaGetLastError();
}
