// The banded-DP kernel shared by banded_dp16.cu (W = 63: 128 slots, byte
// trace) and banded_dp32.cu (v1: 256 slots, int32 records). Each of those
// files states its function and instantiates banded_dp<K> with a policy K:
// slots per lane, INF, whether slot 0 can be valid, the code word per lane,
// and how a traceback row becomes its output.
//
// Design (for the H100's row latency). One warp per pair, one warp per
// block, SPL = W / 32 slots per lane. A pair's rows are a dependent chain,
// so every load and all bookkeeping stay off it:
// - forward row (dp_row): the lane's target bytes live in registers and
//   slide by one slot per row with a shuffle; the query byte and lane 31's
//   new target byte come from registers loaded 32 rows ahead, and each
//   row's match bits are made during the row before. The chain is a
//   5-step __shfl_up_sync prefix-min of (base - k) and one shuffle that
//   feeds it: each lane makes the part of the carry that needs its left
//   neighbour's up move itself, so the up-neighbour shuffle runs beside the
//   scan. Validity and move costs fold into saturating add-min steps.
// - records: a row's record (the lanes' codes, then SPL "not left" and SPL
//   "up" masks from __ballot_sync; bit l of mask r is slot SPL * l + r) is
//   built and stored, fire-and-forget, while the next row's chain runs.
// - traceback: the records are staged in shared memory TB_ROWS rows ahead
//   with cp.async (double-buffered) and lane 0 alone walks the rows. The
//   next kk comes from the row's masks alone (trace_step: __clz on each
//   mask, a max tree); a row's output is made beside the next row's step
//   and leaves in coalesced chunks. No warp-wide step and no device-memory
//   load sits on the kk chain.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nsdp {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TB_ROWS = 64;         // records per staged traceback chunk

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage records [c * TB_ROWS, min(m, (c + 1) * TB_ROWS)) of a pair
// (row_bytes each, a multiple of 16) into buffer c & 1; one commit group.
__device__ __forceinline__ void stage_rows(uint8_t* smem, const uint8_t* dir,
                                           int c, int m, int row_bytes,
                                           int lane) {
    const int r0 = c * TB_ROWS;
    const int nbytes = (min(m, r0 + TB_ROWS) - r0) * row_bytes;
    const uint8_t* src = dir + (int64_t)r0 * row_bytes;
    uint8_t* dst = smem + (c & 1) * TB_ROWS * row_bytes;
    for (int x = 16 * lane; x < nbytes; x += 16 * 32)
        cp_async16(dst + x, src + x);
    cp_async_commit();
}

// The lane's target window for row 1: bytes t[1 + SPL * lane + r].
template <int SPL>
__device__ __forceinline__ void load_window(uint32_t (&tw)[SPL / 4],
                                            const uint8_t* t, int lane) {
#pragma unroll
    for (int w = 0; w < SPL / 4; ++w) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
            v |= (uint32_t)t[1 + SPL * lane + 4 * w + b] << (8 * b);
        tw[w] = v;
    }
}

// Slide the window by one slot: byte r + 1 becomes byte r; the top byte is
// the next lane's byte 0, and lane 31's is `top`.
template <int SPL>
__device__ __forceinline__ void slide_window(uint32_t (&tw)[SPL / 4],
                                             uint32_t top, int lane) {
    uint32_t nb = __shfl_down_sync(FULL, tw[0], 1);
    if (lane == 31) nb = top;
#pragma unroll
    for (int w = 0; w < SPL / 4; ++w)
        tw[w] = __byte_perm(tw[w], w + 1 < SPL / 4 ? tw[w + 1] : nb, 0x4321);
}

// The match bits of a row: bit r is set where slot SPL * lane + r's
// target byte equals the row's query byte qc.
template <int SPL>
__device__ __forceinline__ uint32_t match_bits(const uint32_t (&tw)[SPL / 4],
                                               int qc) {
    uint32_t mb = 0;
#pragma unroll
    for (int r = 0; r < SPL; ++r)
        mb |= (uint32_t)((int)((tw[r >> 2] >> (8 * (r & 3))) & 0xFFu) == qc)
              << r;
    return mb;
}

// One forward row i of the lane's slots k = k0 + r: prev (row i - 1's
// costs) becomes row i's, and diag / up are left as the row's record needs
// them. Exactly the recurrence the kernels' headers state, rewritten:
//   diag = min(prev + pen, INF), pen = mismatch (0 / 1) where the column j
//     is in [1, n], INF elsewhere (unsigned, so INF + INF cannot wrap);
//   up   = min(prev[k + 1] + 1, INF) (INF at the top slot);
//   base = max(min(diag, up), jinf), jinf = 0 on valid slots, INF elsewhere;
//   xk   = min(xk[k - 1] + 1, base) within the lane, i.e. (prefix-min of
//     base - k) + k, and cur = max(min(xk, carry + k), jinf) with carry the
//     prefix-min of base - k over the slots of the lanes before.
template <int SPL, int KOFF, int INF, bool SLOT0_VALID>
__device__ __forceinline__ void dp_row(int (&prev)[SPL], int (&diag)[SPL],
                                       int (&up)[SPL], uint32_t match, int i,
                                       int d0, int n, int k0, int lane) {
    constexpr int R = SPL - 1;                  // the lane's last slot
    const int nxt = __shfl_down_sync(FULL, prev[0], 1);
    const int j0 = d0 + i + k0 - KOFF;          // column of slot k0
    int jinf[SPL], base[SPL], xk[SPL];
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
        const int j = j0 + r;
        const bool jv = (SLOT0_VALID || k0 + r >= 1) &&
                        (unsigned)j <= (unsigned)n;
        jinf[r] = jv ? 0 : INF;
        const unsigned pen = (unsigned)(j - 1) < (unsigned)n
                                 ? (((match >> r) & 1u) ^ 1u) : (unsigned)INF;
        diag[r] = (int)min((unsigned)prev[r] + pen, (unsigned)INF);
        if (r < R) {                            // k < W - 1 here
            up[r] = min(prev[r + 1] + 1, INF);
            base[r] = max(min(diag[r], up[r]), jinf[r]);
            xk[r] = r > 0 ? min(xk[r - 1] + 1, base[r]) : base[r];
        }
    }
    // Lane l's carry-in is the minimum of (base - k) over the slots of the
    // lanes before it. Lane l-1's part is its minimum without its last
    // slot's up move (a), shifted up one lane, and that up move (b), which
    // lane l makes itself: the up neighbour of slot k0 - 1 is this lane's
    // slot 0. So the scan does not wait for the up-neighbour shuffle.
    const int a = min(xk[R - 1] + 1, max(diag[R], jinf[R])) - (k0 + R);
    const int jb = j0 - 1;
    const bool jvb = (SLOT0_VALID || k0 >= 2) && (unsigned)jb <= (unsigned)n;
    const int b = (jvb ? min(prev[0] + 1, INF) : INF) - (k0 - 1);
    int carry = min(__shfl_up_sync(FULL, a, 1), b);
    if (lane == 0) carry = INF;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, carry, off);
        if (lane >= off) carry = min(carry, v);
    }
    up[R] = lane == 31 ? INF : min(nxt + 1, INF);
    base[R] = max(min(diag[R], up[R]), jinf[R]);
    xk[R] = min(xk[R - 1] + 1, base[R]);
    const int ck = carry + k0;
#pragma unroll
    for (int r = 0; r < SPL; ++r)
        prev[r] = max(min(xk[r], ck + r), jinf[r]);
}

// One traceback row: kp = the highest slot <= kk whose code is not left
// (bit l of nl[r] is slot SPL * l + r), and whether its code is up. Returns
// 2 * kp + up, or a negative even value when no slot qualifies. Branch-free,
// with the SPL masks searched side by side and a max tree: kk's chain to
// the next row is this and one add.
template <int SPL>
__device__ __forceinline__ int trace_step(const uint32_t* nl,
                                          const uint32_t* up, int kk) {
    int p[SPL];
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
        // lanes l < c have slot SPL * l + r <= kk (kk >= -1, so c >= 0)
        const unsigned c = (unsigned)(kk + SPL - r) / SPL;
        const unsigned b = nl[r] & __funnelshift_rc(0xFFFFFFFFu, 0u, 32 - c);
        const int z = __clz(b);                      // 32 when b is 0
        const unsigned top = __funnelshift_rc(0x80000000u, 0u, z);
        p[r] = 2 * (SPL * (31 - z) + r) + ((up[r] & top) != 0);
    }
#pragma unroll
    for (int w = SPL / 2; w >= 1; w /= 2)
#pragma unroll
        for (int r = 0; r < w; ++r) p[r] = max(p[r], p[r + w]);
    return p[0];
}

// Bytes of one record: the lanes' code words, then the two mask sets.
template <class K>
__host__ __device__ constexpr int row_bytes() {
    return 32 * (int)sizeof(typename K::Code) + 8 * K::SPL;
}

// Dynamic shared memory of a block: two staged chunks of records and one
// chunk of outputs (plus one slot, see the traceback).
template <class K>
__host__ __device__ constexpr int smem_bytes() {
    return 2 * TB_ROWS * row_bytes<K>() +
           (int)sizeof(typename K::Trace) * (TB_ROWS + 1);
}

// The kernel body: block b aligns pair b. Outputs as the kernels' headers
// state; `dirs` is the wrapper's scratch of dirs_rows records per pair.
template <class K>
__device__ __forceinline__ void banded_dp(
    const int32_t* __restrict__ d0s, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ maxcs,
    const uint8_t* __restrict__ tpad, int64_t t_stride,
    const uint8_t* __restrict__ qbuf, int64_t q_stride,
    int32_t* __restrict__ cost_out, int32_t* __restrict__ len_out,
    int32_t* __restrict__ ts_out, int32_t* __restrict__ te_out,
    typename K::Trace* __restrict__ trace, int64_t tr_stride,
    uint8_t* __restrict__ dirs, int64_t dirs_rows, int n_pairs)
{
    using Code = typename K::Code;
    using Trace = typename K::Trace;
    constexpr int SPL = K::SPL, W = 32 * SPL, KOFF = K::KOFF, INF = K::INF;
    constexpr int CODE_BITS = K::CODE_BITS;
    constexpr int MASKS = 32 * (int)sizeof(Code);   // masks' offset in a row
    constexpr int ROW_BYTES = row_bytes<K>();
    extern __shared__ __align__(16) uint8_t smem[];
    const int pair = blockIdx.x;
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
    uint8_t* dir = dirs + (int64_t)pair * dirs_rows * ROW_BYTES;
    Trace* tr = trace + (int64_t)pair * tr_stride;
    const int k0 = SPL * lane;
    const int t_last = m + W - 1;    // highest target byte a row reads

    int prev[SPL];
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
        const int k = k0 + r;
        const int j0 = d0 + k - KOFF;
        prev[r] = ((K::SLOT0_VALID || k >= 1) && j0 >= 0 && j0 <= n)
                      ? 0 : INF;
    }
    uint32_t tw[SPL / 4];
    load_window<SPL>(tw, t, lane);
    // rows i0+1 .. i0+32 read q[i0 + s] and, sliding after row i0+1+s,
    // the new top byte t[i0 + W + 1 + s]: lane s holds both
    int qn = lane < m ? q[lane] : 0;
    uint32_t tn = W + 1 + lane <= t_last ? t[W + 1 + lane] : 0xFFu;
    // a row's diag, up and match bits, kept for its record, which is
    // written while the next row's chain runs
    int diag[SPL] = {}, up[SPL] = {};
    uint32_t rmatch = 0;
    auto record = [&](int row_i) {
        uint32_t codes = 0, nl[SPL], upm[SPL];
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
            int d = prev[r] == diag[r] ? ((rmatch >> r) & 1 ? 4 : 0)
                                       : (prev[r] == up[r] ? 1 : 2);
            if (prev[r] >= INF) d = 3;
            codes |= (uint32_t)d << (CODE_BITS * r);
            nl[r] = __ballot_sync(FULL, d != 2);
            upm[r] = __ballot_sync(FULL, d == 1);
        }
        uint8_t* row = dir + (int64_t)(row_i - 1) * ROW_BYTES;
        reinterpret_cast<Code*>(row)[lane] = (Code)codes;
        if (lane == 0) {
            uint4* mk = reinterpret_cast<uint4*>(row + MASKS);
#pragma unroll
            for (int v = 0; v < SPL / 4; ++v) {
                mk[v] = make_uint4(nl[4 * v], nl[4 * v + 1], nl[4 * v + 2],
                                   nl[4 * v + 3]);
                mk[SPL / 4 + v] = make_uint4(upm[4 * v], upm[4 * v + 1],
                                             upm[4 * v + 2], upm[4 * v + 3]);
            }
        }
    };

    // the match bits of row 1; each row makes the next row's
    uint32_t match = match_bits<SPL>(tw, __shfl_sync(FULL, qn, 0));
    for (int i0 = 0; i0 < m; i0 += 32) {
        const int xq = i0 + 32 + lane, xt = i0 + 32 + W + 1 + lane;
        const int qn_next = xq < m ? q[xq] : 0;
        const uint32_t tn_next = xt <= t_last ? t[xt] : 0xFFu;
        const int rows = min(32, m - i0);
        for (int s = 0; s < rows; ++s) {
            const int i = i0 + s + 1;
            // row i-1's record (at i = 1 a placeholder for row 1, which
            // its real record overwrites); no branch, so it interleaves
            record(max(i - 1, 1));
            rmatch = match;
            dp_row<SPL, KOFF, INF, K::SLOT0_VALID>(prev, diag, up, match, i,
                                                   d0, n, k0, lane);
            slide_window<SPL>(tw, __shfl_sync(FULL, tn, s), lane);
            // the next row's query byte is in the next chunk's registers
            // after row i0 + 32
            match = match_bits<SPL>(
                tw, __shfl_sync(FULL, s + 1 < 32 ? qn : qn_next, (s + 1) & 31));
        }
        qn = qn_next;
        tn = tn_next;
    }
    record(m);

    int bl = K::BL0, bkl = W;
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
        const int k = k0 + r;
        const int jm = d0 + m + k - KOFF;
        const int f = ((K::SLOT0_VALID || k >= 1) && jm >= 0 && jm <= n)
                          ? prev[r] : K::FINAL_INVALID;
        if (f < bl) { bl = f; bkl = k; }
    }
    const int best = __reduce_min_sync(FULL, bl);
    const int best_k = __reduce_min_sync(FULL, bl == best ? bkl : W);

    if (best > maxc) {               // rejected: cost -1, zero outputs
        for (int i = lane; i < m; i += 32) tr[i] = 0;
        if (lane == 0) {
            cost_out[pair] = -1; len_out[pair] = 0;
            ts_out[pair] = 0; te_out[pair] = 0;
        }
        return;
    }

    // the forward pass's records, read back through cp.async below
    __threadfence();
    __syncwarp();
    Trace* out = reinterpret_cast<Trace*>(smem + 2 * TB_ROWS * ROW_BYTES);
    int kk = best_k;
    int ndel = 0;
    auto masks = [&](const uint8_t* row, uint32_t (&nl)[SPL],
                     uint32_t (&upm)[SPL]) {
        const uint4* mk = reinterpret_cast<const uint4*>(row + MASKS);
#pragma unroll
        for (int v = 0; v < SPL / 4; ++v) {
            const uint4 a = mk[v], b = mk[SPL / 4 + v];
            nl[4 * v] = a.x; nl[4 * v + 1] = a.y;
            nl[4 * v + 2] = a.z; nl[4 * v + 3] = a.w;
            upm[4 * v] = b.x; upm[4 * v + 1] = b.y;
            upm[4 * v + 2] = b.z; upm[4 * v + 3] = b.w;
        }
    };
    // a row's output from the lane's code word that holds slot kp, kp
    // itself and the kk it was found from
    auto emit = [&](uint32_t word, int kp, int kk_row) -> Trace {
        const int dv = kp >= 0
            ? (int)((word >> (CODE_BITS * (kp & (SPL - 1)))) & 7u) : -1;
        return K::output(dv, kk_row - kp, ndel);
    };
    const int chunks = (m + TB_ROWS - 1) / TB_ROWS;
    stage_rows(smem, dir, chunks - 1, m, ROW_BYTES, lane);
    for (int c = chunks - 1; c >= 0; --c) {
        if (c > 0) {
            stage_rows(smem, dir, c - 1, m, ROW_BYTES, lane);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncwarp();
        const int r0 = c * TB_ROWS;
        const int rows = min(m, r0 + TB_ROWS) - r0;
        if (lane == 0) {
            // row r0 + 1 + x of the pair is record x of the chunk
            const uint8_t* buf = smem + (c & 1) * TB_ROWS * ROW_BYTES;
            uint32_t nl[SPL], upm[SPL];
            masks(buf + (rows - 1) * ROW_BYTES, nl, upm);
            // the previous record's code word, kp and kk: its output is
            // made beside this record's step (the first is a no-op with
            // dels 0, written past the chunk's outputs)
            uint32_t word = 0;
            int hkp = 0, hkk = 0;
            for (int x = rows - 1; x >= 0; --x) {
                const uint8_t* row = buf + x * ROW_BYTES;
                const int pk = trace_step<SPL>(nl, upm, kk);
                masks(buf + max(x - 1, 0) * ROW_BYTES, nl, upm);
                out[x + 1] = emit(word, hkp, hkk);
                const int kp = max(pk >> 1, -1);
                word = reinterpret_cast<const Code*>(row)[max(kp, 0) / SPL];
                hkp = kp;
                hkk = kk;
                kk = kp + (pk & 1);
            }
            out[0] = emit(word, hkp, hkk);
        }
        __syncwarp();
        for (int x = lane; x < rows; x += 32) tr[r0 + x] = out[x];
    }
    if (lane == 0) {
        cost_out[pair] = best;
        len_out[pair] = m + ndel;
        ts_out[pair] = d0 + kk - KOFF;
        te_out[pair] = d0 + m + best_k - KOFF;
    }
}

}  // namespace nsdp
