// Banded glocal DP with 256 band slots, int32 costs and one int32 record
// per query row: the Python wavefront's batch DP.
//
// Replaces the v1 Pallas kernel _kernel of nanospring_tpu/ops/align_tpu.py
// (:60, pallas_call in _align_padded at :217), which runs 8 pairs per grid
// program as one (8, 256) int32 block. Its 8,192-row cap is the TPU's VMEM
// limit and is not carried over: the direction codes live in device memory
// here, so one kernel takes every row count up to the wrapper's 131,072.
// (The wavefront keeps the reference's route rule all the same: it sends
// only batches up to 8,192 rows here, ops/align_tpu.py M_PAD_MAX.)
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
// Design: banded_dp_common.cuh's kernel, as in banded_dp16.cu, at 8 slots
// per lane; a record is 192 B: the lanes' codes in 4-bit fields of one
// 32-bit word each, then 8 "not left" and 8 "up" masks.
//
// Bound. A launch costs its longest query's rows times the chain's cycles
// per row. On an H100 80GB HBM3 at 700 W (a clock64()-stamped build, 96
// pairs, longest 8,028 rows, cycles at the 1,980 MHz maximum SM clock)
// that is 912 cycles per row: 650 in the forward row and 257 in the
// traceback row. The operations bound that PERF.md uses counts 8
// integer operations per band cell (256 cells per row) at the card's int32
// throughput, and the bytes are a few per row: both far below what the
// chain allows.
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_dp_common.cuh"

namespace {

struct Dp32 {
    static constexpr int SPL = 8;                 // 256 slots
    static constexpr int KOFF = 128;
    static constexpr int INF = 1 << 30;
    static constexpr bool SLOT0_VALID = true;
    static constexpr int BL0 = 0x7FFFFFFF;        // empty final minimum
    static constexpr int FINAL_INVALID = INF;
    static constexpr int CODE_BITS = 4;
    using Code = uint32_t;
    using Trace = int32_t;
    // record dels + (optype << 16) + (match << 18), optype 3 and match -1
    // where no slot qualifies; every row's dels count
    __device__ static int32_t output(int dv, int dels, int& ndel) {
        const int optype = dv < 0 ? 3 : (dv & 3);
        const int mbit = dv < 0 ? -1 : (dv >> 2);
        ndel += dels;
        return dels + optype * (1 << 16) + mbit * (1 << 18);
    }
};

__global__ void __launch_bounds__(32)
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
                   uint8_t* __restrict__ dirs, int64_t dirs_rows,
                   int n_pairs)
{
    nsdp::banded_dp<Dp32>(d0s, qlens, tlens, maxcs, tpad, t_stride, qbuf,
                          q_stride, cost_out, len_out, ts_out, te_out, trace,
                          tr_stride, dirs, dirs_rows, n_pairs);
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
    banded_dp32_kernel<<<n_pairs, 32, nsdp::smem_bytes<Dp32>(),
                         (cudaStream_t)stream>>>(
        (const int32_t*)d0, (const int32_t*)qlen, (const int32_t*)tlen,
        (const int32_t*)maxc, (const uint8_t*)tpad, t_stride,
        (const uint8_t*)qbuf, q_stride, (int32_t*)cost, (int32_t*)ops_len,
        (int32_t*)ts, (int32_t*)te, (int32_t*)trace, tr_stride,
        (uint8_t*)dirs, dirs_rows, n_pairs);
    return (int)cudaGetLastError();
}

// Bytes of one row of the `dirs` scratch the launcher expects.
extern "C" int ns_banded_dp32_row_bytes() { return nsdp::row_bytes<Dp32>(); }
