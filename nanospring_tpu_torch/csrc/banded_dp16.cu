// Batch banded DP with a byte trace, W = 63, for every row count.
//
// Replaces the four Pallas kernels of nanospring_tpu/ops/align_tpu.py that
// compute this one function: _kernel16 (v2, <= 8,192 rows), _kernel16t2
// and _kernel16t (row-tiled, <= 65,536 / 131,072 rows) and _kernel16q
// (quad-block). All four produce the same outputs; the tiling and the
// multi-block programs exist only for the TPU's 16 MB VMEM and its (8, 128)
// vector shape. Here the direction codes of every row live in device
// memory, so one kernel covers every row count the engine's hook sends.
//
// The function (per pair: d0, m = query length, n = target length, maxc):
//   slot k in [0, 128) <-> target column j = d0 + i + k - 64; slot 0 and
//   columns outside [0, n] are invalid. tpad[x] = t[x + d0 - 65], so the
//   target base of slot k in row i is tpad[i + k].
//   row 0:  prev[k] = 0 on valid slots, INF elsewhere.
//   row i:  diag = prev[k] + (t[j-1] != q[i-1])   (1 <= j <= n, prev < INF)
//           up   = prev[k+1] + 1                  (k < 127, prev < INF)
//           base = min(diag, up) on valid slots, INF elsewhere
//           cur  = min(base, k + prefixmin_k'<=k(base[k'] - k'))   (left)
//           code = cur == diag ? (match ? 4 : 0) : cur == up ? 1 : 2,
//                  and 3 where cur >= INF.
//   best = min over valid final slots (invalid = 1 << 20), best_k its
//   lowest slot; the pair is rejected (cost -1) when best > maxc.
//   Traceback from kk = best_k, rows m..1: kp = highest slot <= kk whose
//   code is not left; dels = kk - kp; byte = op2 << 6 | dels, op2 0 '=',
//   1 's', 2 'i'; 255 when dels > 62, the code is 3 or no slot qualifies;
//   next kk = kp + (code is up). ops_len = m + sum of dels over rows that
//   did not escape, tstart = d0 + kk_final - 64, tend = d0 + m + best_k - 64.
// INF stays 0x3FFF, the TPU kernels' int16 sentinel, although int32 lanes
// could hold more: costs at or above it escape exactly as they do there.
//
// Design: banded_dp_common.cuh's kernel (one warp per pair, target bytes
// in registers, records built beside the chain, the traceback walked by one
// thread over records staged with cp.async), at 4 slots per lane; a record
// is 96 B: the lanes' 3-bit codes as one uint16 each, then 4 "not left"
// and 4 "up" masks.
//
// Bound. A launch costs its longest query's rows times the chain's cycles
// per row. On an H100 80GB HBM3 at 700 W (a clock64()-stamped build, 58
// pairs, longest 14,156 rows, cycles at the 1,980 MHz maximum SM clock)
// that is 594 cycles per row: 413 in the forward row and 180 in the
// traceback row. The operations bound that PERF.md uses counts 8
// integer operations per band cell (128 cells per row) at the card's int32
// throughput, and the bytes are a few per row: both far below what the
// chain allows.
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_dp_common.cuh"

namespace {

struct Dp16 {
    static constexpr int SPL = 4;                 // 128 slots
    static constexpr int KOFF = 64;
    static constexpr int INF = 0x3FFF;
    static constexpr bool SLOT0_VALID = false;
    static constexpr int BL0 = 1 << 20;           // invalid final slot
    static constexpr int FINAL_INVALID = 1 << 20;
    static constexpr int CODE_BITS = 3;
    using Code = uint16_t;
    using Trace = uint8_t;
    // trace byte op2 << 6 | dels, 255 on escape; escaped rows add no dels
    __device__ static uint8_t output(int dv, int dels, int& ndel) {
        const int optype = dv < 0 ? 3 : (dv & 3);
        const int mbit = dv < 0 ? -1 : (dv >> 2);
        const int op2 = optype == 1 ? 2 : (mbit == 1 ? 0 : 1);
        const bool esc = dels > 62 || optype >= 3 || dv < 0;
        if (!esc) ndel += dels;
        return esc ? 255 : (uint8_t)((op2 << 6) | dels);
    }
};

__global__ void __launch_bounds__(32)
banded_dp16_kernel(const int32_t* __restrict__ d0s,
                   const int32_t* __restrict__ qlens,
                   const int32_t* __restrict__ tlens,
                   const int32_t* __restrict__ maxcs,
                   const uint8_t* __restrict__ tpad, int64_t t_stride,
                   const uint8_t* __restrict__ qbuf, int64_t q_stride,
                   int32_t* __restrict__ cost_out,
                   int32_t* __restrict__ len_out,
                   int32_t* __restrict__ ts_out,
                   int32_t* __restrict__ te_out,
                   uint8_t* __restrict__ trace, int64_t tr_stride,
                   uint8_t* __restrict__ dirs, int64_t dirs_rows,
                   int n_pairs)
{
    nsdp::banded_dp<Dp16>(d0s, qlens, tlens, maxcs, tpad, t_stride, qbuf,
                          q_stride, cost_out, len_out, ts_out, te_out, trace,
                          tr_stride, dirs, dirs_rows, n_pairs);
}

}  // namespace

// ev0 and ev1, where not null, are CUDA events recorded on the stream
// right before and right after the kernel, so that they time it alone.
extern "C" int ns_banded_dp16_launch(
    const void* d0, const void* qlen, const void* tlen, const void* maxc,
    const void* tpad, int64_t t_stride, const void* qbuf, int64_t q_stride,
    void* cost, void* ops_len, void* ts, void* te,
    void* trace, int64_t tr_stride, void* dirs, int64_t dirs_rows,
    int n_pairs, void* stream, void* ev0, void* ev1)
{
    if (n_pairs <= 0) return 0;
    cudaError_t err = cudaSuccess;
    if (ev0 != nullptr)
        err = cudaEventRecord((cudaEvent_t)ev0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    banded_dp16_kernel<<<n_pairs, 32, nsdp::smem_bytes<Dp16>(),
                         (cudaStream_t)stream>>>(
        (const int32_t*)d0, (const int32_t*)qlen, (const int32_t*)tlen,
        (const int32_t*)maxc, (const uint8_t*)tpad, t_stride,
        (const uint8_t*)qbuf, q_stride, (int32_t*)cost, (int32_t*)ops_len,
        (int32_t*)ts, (int32_t*)te, (uint8_t*)trace, tr_stride,
        (uint8_t*)dirs, dirs_rows, n_pairs);
    err = cudaGetLastError();
    if (err == cudaSuccess && ev1 != nullptr)
        err = cudaEventRecord((cudaEvent_t)ev1, (cudaStream_t)stream);
    return (int)err;
}

// Bytes of one row of the `dirs` scratch the launcher expects.
extern "C" int ns_banded_dp16_row_bytes() { return nsdp::row_bytes<Dp16>(); }

// Strided copy of `height` rows of `width` bytes between host and device
// (either direction), on `stream`: the device DP hook moves only the used
// pairs and query rows of its fixed-capacity buffers.
extern "C" int ns_copy2d(void* dst, int64_t dpitch, const void* src,
                         int64_t spitch, int64_t width, int64_t height,
                         void* stream)
{
    if (width <= 0 || height <= 0) return 0;
    return (int)cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch,
                                  (size_t)width, (size_t)height,
                                  cudaMemcpyDefault, (cudaStream_t)stream);
}

extern "C" const char* ns_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
