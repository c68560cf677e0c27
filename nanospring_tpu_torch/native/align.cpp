// Banded glocal alignment with traceback — the edit-script engine.
//
// From-scratch replacement for the reference's minimap2 usage
// (reference: src/ConsensusGraph.cpp:161-398 calls mm_idx_str + mm_map per
// candidate and converts CIGAR to SAME/sub runs; internals at
// minimap2/align.c ksw_extz2_sse). Design differences:
//   - no per-call index build: the caller supplies an expected diagonal d0
//     from the seed/anchor stage, and we run one banded unit-cost DP
//     ("glocal": query consumed fully, target start/end free inside the
//     window), O(m * (2W+1)) time, traceback to explicit edit ops.
//   - ops come back as bytes: '=' copy, 's' substitution, 'i' insertion
//     (query-only base), 'd' deletion (target-only base) — directly
//     convertible to the archive's pos/type/base streams.
//
// Band coordinates: slot k = j - i - d0 + W for query row i, target col j,
// k in [0, 2W]. Moves: diag (i-1,j-1) same k; up/ins (i-1,j) k+1; left/del
// (i,j-1) k-1.
//
// C ABI only (consumed via ctypes).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t INF = 0x3FFFFFFF;

struct Scratch {
    std::vector<int32_t> row0, row1;
    std::vector<uint8_t> dirs;  // (m+1) x (2W+1), 0=diag,1=up,2=left,3=start
    std::vector<uint8_t> tpad;  // diagonal-shifted target slice + sentinels
    std::vector<int32_t> va, vb;  // prefix-min ping-pong buffers
};

thread_local Scratch g_scratch;

}  // namespace

extern "C" {

// Returns cost >= 0 on success, -1 if max_cost exceeded (early abort),
// -2 if output capacity too small.
// ops_out must have capacity >= 2*m + 2*W + 2.
int32_t ns_banded_align(
    const uint8_t* target, int64_t n,
    const uint8_t* query, int64_t m,
    int64_t d0, int32_t W, int32_t max_cost,
    uint8_t* ops_out, int64_t ops_cap, int64_t* ops_len,
    int64_t* tstart_out, int64_t* tend_out)
{
    const int64_t width = 2 * (int64_t)W + 1;
    Scratch& s = g_scratch;
    s.row0.assign(width + 1, INF);   // +1: INF sentinel for up at k=width-1
    s.row1.assign(width + 1, INF);
    // no fill: every dirs row in [1, m] is fully written by the DP loop
    // and the traceback never reads row 0 (a per-pair memset here was
    // ~0.5 MB/pair of pure overhead)
    if (s.dirs.size() < (size_t)(m + 1) * width)
        s.dirs.resize((size_t)(m + 1) * width);
    // tpad[x] = target[x + d0 - W - 1], 0xFF sentinel outside: row i's
    // diag chars are the contiguous slice tpad[i .. i+width) (no per-cell
    // bounds checks; boundary validity is handled by the klo/khi clip).
    s.tpad.assign((size_t)(m + width + 1), 0xFF);
    s.va.resize(width);
    s.vb.resize(width);
    {
        int64_t lo = d0 - W - 1;
        int64_t b = lo < 0 ? -lo : 0;
        int64_t e = (int64_t)s.tpad.size();
        if (lo + e > n) e = n - lo;
        if (e > b) std::memcpy(s.tpad.data() + b, target + lo + b, (size_t)(e - b));
    }

    // row 0: start anywhere in target within the band (j = d0 - W + k)
    for (int64_t k = 0; k < width; ++k) {
        int64_t j = d0 - W + k;
        if (j >= 0 && j <= n) s.row0[k] = 0;
    }
    // left (del) moves in row 0 are never useful (all starts are free).

    int32_t* prev = s.row0.data();
    int32_t* cur = s.row1.data();

    for (int64_t i = 1; i <= m; ++i) {
        const int32_t qc = query[i - 1];
        uint8_t* dir_row = s.dirs.data() + (size_t)i * width;
        const uint8_t* trow = s.tpad.data() + i;   // diag char per slot
        const int64_t jbase = d0 + i - W;          // j for k=0 in this row
        // valid slots: j in [0, n] -> k in [klo, khi]
        int64_t klo = jbase < 0 ? -jbase : 0;
        int64_t khi = n - jbase;
        if (khi > width - 1) khi = width - 1;
        // a row with no valid slot (the diagonal lies more than a band
        // before the target's start or past its end) writes only its own
        // width slots: klo <= width, khi >= -1
        if (klo > width) klo = width;
        if (khi < -1) khi = -1;
        for (int64_t k = 0; k < klo; ++k) { cur[k] = INF; dir_row[k] = 3; }
        for (int64_t k = khi + 1; k < width; ++k) { cur[k] = INF; dir_row[k] = 3; }
        // vector pass (branch-free, auto-vectorizes): diag vs up.
        // diag at j==0 (k==klo when jbase<0) is invalid; tpad sentinel 0xFF
        // mismatches, but prev[k] there is INF-ish from the prior row clip,
        // handled below by the explicit k==klo fix when j==0.
        {
            const int32_t* __restrict pv = prev;
            int32_t* __restrict cv = cur;
            uint8_t* __restrict dv = dir_row;
            const uint8_t* __restrict tv = trow;
            #pragma GCC ivdep
            for (int64_t k = klo; k <= khi; ++k) {
                int32_t diag = pv[k] + (int32_t)(tv[k] != qc);
                int32_t up = pv[k + 1] + 1;
                cv[k] = diag < up ? diag : up;        // tie keeps up
                dv[k] = (uint8_t)(up <= diag);
            }
        }
        if (klo <= khi && jbase + klo == 0) {
            // j == 0: no diag (no target char); only up is legal
            int32_t up = prev[klo + 1] + 1;
            cur[klo] = up;
            dir_row[klo] = 1;
        }
        // left-move chains as a prefix-min (no serial dependency):
        // result[k] = k + min_{k'<=k}(cur[k'] - k'), via log2(width)
        // shifted-min passes, each fully vectorizable.
        {
            const int64_t span = khi - klo + 1;
            int32_t* __restrict a = s.va.data();
            int32_t* __restrict b = s.vb.data();
            for (int64_t k = 0; k < span; ++k)
                a[k] = cur[klo + k] - (int32_t)k;
            for (int64_t sh = 1; sh < span; sh <<= 1) {
                for (int64_t k = span - 1; k >= sh; --k)
                    b[k] = a[k] < a[k - sh] ? a[k] : a[k - sh];
                for (int64_t k = 0; k < sh && k < span; ++k) b[k] = a[k];
                std::swap(a, b);
            }
            int32_t row_min = INF;
            for (int64_t k = 0; k < span; ++k) {
                int32_t chained = a[k] + (int32_t)k;
                int32_t c = cur[klo + k];
                if (chained < c) { cur[klo + k] = chained; dir_row[klo + k] = 2; }
                else chained = c;
                if (chained < row_min) row_min = chained;
            }
            if (row_min > max_cost) return -1;
            // divergence-slope abort: a genuine overlap accumulates cost
            // at most ~0.19/row (old-basecaller read vs raw-seed
            // consensus, both ~10% error), while a wrong-locus pair
            // tracks ~0.5/row (random DNA), which crosses the 50%
            // admission budget only at the matrix end — so without this
            // check every reject pays the full band*len. 0.35/row + 240
            // (~1.8x the worst genuine slope, burst headroom) aborts
            // divergent pairs at ~1/3 depth with the same final
            // accept/reject verdict for anything below the slope.
            if (row_min > (int32_t)((i * 7) / 20) + 240) return -1;
        }
        std::swap(prev, cur);
    }

    // answer: min over final row (free target end), j must be in [0, n]
    int64_t best_k = -1;
    int32_t best_cost = INF;
    int64_t jbase_m = d0 + m - W;
    for (int64_t k = 0; k < width; ++k) {
        int64_t j = jbase_m + k;
        if (j < 0 || j > n) continue;
        if (prev[k] < best_cost) { best_cost = prev[k]; best_k = k; }
    }
    if (best_k < 0 || best_cost > max_cost) return -1;

    // traceback (ops emitted reversed, then flipped)
    int64_t i = m, k = best_k;
    int64_t len = 0;
    while (i > 0) {
        uint8_t d = s.dirs[(size_t)i * width + k];
        if (len >= ops_cap) return -2;
        if (d == 0) {           // diag
            int64_t j = d0 + i - W + k;
            ops_out[len++] = (target[j - 1] == query[i - 1]) ? '=' : 's';
            i -= 1;             // k unchanged
        } else if (d == 1) {    // up: insertion
            ops_out[len++] = 'i';
            i -= 1; k += 1;
        } else if (d == 2) {    // left: deletion
            ops_out[len++] = 'd';
            k -= 1;
        } else {
            return -3;          // broken traceback
        }
    }
    int64_t tstart = d0 + 0 - W + k;  // j at i == 0
    // flip ops
    for (int64_t a = 0, b = len - 1; a < b; ++a, --b) {
        uint8_t t = ops_out[a]; ops_out[a] = ops_out[b]; ops_out[b] = t;
    }
    *ops_len = len;
    *tstart_out = tstart;
    *tend_out = d0 + m - W + best_k;
    return best_cost;
}

// ---------------------------------------------------------------------------
// Anchor-stitched alignment: verify the (cheap, vectorizable) match runs
// between anchor pins and run banded DP only on the small gap segments.
// This is the role minimap2 plays in the reference — its chain anchors
// bound the ksw_extz2_sse extensions (minimap2/align.c:864,329;
// used from src/ConsensusGraph.cpp:161-247) — so base-level DP touches a
// few percent of the bases instead of all of them.
// ---------------------------------------------------------------------------

namespace {

// NS_ENGINE_DEBUG diagnostics: [0] -4 chain<2, [1] -4 head/tail too deep,
// [2] head -1, [3] middle -1, [4] tail -1, [5] budget -1, [6] ok
std::atomic<int64_t> g_stitch_stats[8];
// profile counters are hot-path atomics (the per-wavefront one fires
// ~7M times per 60 Mb run) — only maintained under NS_ENGINE_DEBUG
const bool g_prof_on = std::getenv("NS_ENGINE_DEBUG") != nullptr;
// profile counters: [0] pairs, [1] verify bases, [2] seg calls,
// [3] wavefront steps, [4] chain pins total, [5] area-DP cells,
// [6] in-band filter anchors scanned
std::atomic<int64_t> g_stitch_prof[8];
// core-reseed diagnostics: [0] calls, [1] ok, [2] budget rejects,
// [3] no-pins fallbacks, [4] area cells via WFA_DCAP fallback,
// [5] -, [6] WFA_DCAP fallback count
std::atomic<int64_t> g_core_prof[8];

struct SegScratch {
    std::vector<int32_t> r0, r1;
    std::vector<uint8_t> dirs;
    std::vector<uint8_t> rops;
};
thread_local SegScratch g_seg;

// Banded global/semi-global DP on one small segment.
//   band: j - i in [dlo, dhi]
//   free_start: row 0 costs 0 at every in-band j (else only (0,0))
//   free_end:   answer is min over row m (else pinned at j == n)
// Appends ops ('=','s','i','d') to ops_out at *len (caller-checked cap),
// sets *ts (start j) and *te (end j). Returns segment cost, or -1 if the
// pinned cells are unreachable within the band / budget.
int32_t seg_align(const uint8_t* t, int64_t n, const uint8_t* q, int64_t m,
                  int64_t dlo, int64_t dhi, bool free_start, bool free_end,
                  int32_t budget,
                  uint8_t* ops_out, int64_t ops_cap, int64_t* len,
                  int64_t* ts, int64_t* te)
{
    const int64_t width = dhi - dlo + 1;
    if (width <= 0) return -1;
    if (g_prof_on) {
        g_stitch_prof[2].fetch_add(1, std::memory_order_relaxed);
        g_stitch_prof[5].fetch_add(width * m, std::memory_order_relaxed);
    }
    SegScratch& s = g_seg;
    s.r0.assign((size_t)(width + 2), INF);
    s.r1.assign((size_t)(width + 2), INF);
    if (s.dirs.size() < (size_t)((m + 1) * width))
        s.dirs.resize((size_t)((m + 1) * width));
    int32_t* prev = s.r0.data() + 1;   // sentinel INF at both ends
    int32_t* cur = s.r1.data() + 1;
    // row 0: j = dlo + k
    for (int64_t k = 0; k < width; ++k) {
        const int64_t j = dlo + k;
        if (j < 0 || j > n) continue;
        if (free_start) prev[k] = 0;
        else if (j == 0) prev[k] = 0;
    }
    if (!free_start) {
        // left (del) moves from (0,0) along row 0 cost j
        for (int64_t k = 0; k < width; ++k) {
            const int64_t j = dlo + k;
            if (j > 0 && j <= n) {
                const int32_t v = (int32_t)j;
                if (v < prev[k]) prev[k] = v;
            }
        }
    }
    for (int64_t i = 1; i <= m; ++i) {
        const int32_t qc = q[i - 1];
        uint8_t* dir_row = s.dirs.data() + (size_t)(i * width);
        // valid slots this row: j = i + dlo + k in [0, n]
        int64_t klo = -(i + dlo) > 0 ? -(i + dlo) : 0;
        int64_t khi = n - (i + dlo);
        if (khi > width - 1) khi = width - 1;
        if (klo > khi) return -1;   // band exhausted
        for (int64_t k = 0; k < klo; ++k) { cur[k] = INF; dir_row[k] = 3; }
        for (int64_t k = khi + 1; k < width; ++k) {
            cur[k] = INF;
            dir_row[k] = 3;
        }
        int64_t k0 = klo;
        if (i + dlo + klo == 0) {   // j == 0: insertion only
            cur[klo] = prev[klo + 1] + 1;
            dir_row[klo] = 1;
            k0 = klo + 1;
        }
        {   // diag/up pass (branch-free, auto-vectorizes)
            const uint8_t* __restrict tj = t + (i + dlo - 1);
            const int32_t* __restrict pv = prev;
            int32_t* __restrict cv = cur;
            uint8_t* __restrict dv = dir_row;
            #pragma GCC ivdep
            for (int64_t k = k0; k <= khi; ++k) {
                const int32_t diag = pv[k] + (int32_t)(tj[k] != qc);
                const int32_t up = pv[k + 1] + 1;
                cv[k] = diag <= up ? diag : up;    // ties keep diag ('='/'s'
                dv[k] = (uint8_t)(up < diag);      // beats 'i' for ratio)
            }
        }
        // left-chain pass (serial, rarely taken) + row min
        int32_t row_min = cur[klo];
        for (int64_t k = k0 == klo ? klo + 1 : k0; k <= khi; ++k) {
            const int32_t left = cur[k - 1] + 1;
            if (left < cur[k]) { cur[k] = left; dir_row[k] = 2; }
            if (cur[k] < row_min) row_min = cur[k];
        }
        if (row_min > budget) return -1;
        std::swap(prev, cur);
    }
    int64_t best_k = -1;
    int32_t best_cost = INF;
    if (free_end) {
        for (int64_t k = 0; k < width; ++k) {
            const int64_t j = m + dlo + k;
            if (j < 0 || j > n) continue;
            if (prev[k] < best_cost) { best_cost = prev[k]; best_k = k; }
        }
    } else {
        const int64_t k = n - m - dlo;
        if (k >= 0 && k < width && prev[k] < INF) {
            best_cost = prev[k];
            best_k = k;
        }
    }
    if (best_k < 0 || best_cost > budget) return -1;
    // traceback (reversed, then appended forward)
    s.rops.clear();
    int64_t i = m, k = best_k;
    while (i > 0) {
        const uint8_t d = s.dirs[(size_t)(i * width + k)];
        if (d == 0) {
            const int64_t j = i + dlo + k;
            s.rops.push_back(t[j - 1] == q[i - 1] ? '=' : 's');
            i -= 1;
        } else if (d == 1) {
            s.rops.push_back('i');
            i -= 1; k += 1;
        } else if (d == 2) {
            s.rops.push_back('d');
            k -= 1;
        } else {
            return -1;
        }
    }
    int64_t j0 = dlo + k;   // j at i == 0
    if (!free_start && j0 > 0) {
        // row-0 deletions from the pinned (0,0) start
        for (int64_t x = 0; x < j0; ++x) s.rops.push_back('d');
        j0 = 0;
    }
    if (*len + (int64_t)s.rops.size() > ops_cap) return -1;
    for (int64_t x = (int64_t)s.rops.size() - 1; x >= 0; --x)
        ops_out[(*len)++] = s.rops[(size_t)x];
    *ts = j0;
    *te = m + dlo + best_k;
    return best_cost;
}

}  // namespace

namespace {
// NS_STITCH_DUMP=<path-prefix>: dump the first few failing stitch calls
// (whole-pair inputs) for offline inspection.
std::atomic<int32_t> g_dump_n{0};
void stitch_dump(const uint8_t* t, int64_t n, const uint8_t* q, int64_t m,
                 const int64_t* aq, const int64_t* at, int64_t A,
                 int64_t d0, int32_t W, int32_t max_cost, int tag)
{
    const char* pfx = std::getenv("NS_STITCH_DUMP");
    if (!pfx) return;
    const int32_t i = g_dump_n.fetch_add(1);
    if (i >= 6) return;
    char path[512];
    std::snprintf(path, sizeof path, "%s_%d_tag%d.bin", pfx, i, tag);
    FILE* f = std::fopen(path, "wb");
    if (!f) return;
    int64_t hdr[5] = {n, m, A, d0, (int64_t)((int64_t)W << 32 | max_cost)};
    std::fwrite(hdr, sizeof(int64_t), 5, f);
    std::fwrite(t, 1, (size_t)n, f);
    std::fwrite(q, 1, (size_t)m, f);
    std::fwrite(aq, sizeof(int64_t), (size_t)A, f);
    std::fwrite(at, sizeof(int64_t), (size_t)A, f);
    std::fclose(f);
}
}  // namespace

// Stitched glocal alignment of q[0..m) against t[0..n) through anchor pins
// (aq, at) (strictly-positive counts, sorted by aq; window-relative
// coordinates). W bounds the diagonal wander accepted from the pin chain;
// max_cost is the same admission budget ns_banded_align enforces.
// Returns cost >= 0, -1 on reject (budget exceeded / band broken), or
// -4 when the chain is unusable and the caller should run full banded DP.
// Unit-cost wavefront segment aligner (Myers 1986 O(ND) furthest-reaching
// diagonals; the same idea as WFA for unit costs). Replaces the banded
// area DP for the stitch gap cores: cost scales with edits^2 + snake
// bytes instead of band*len cells (the cores carry 1-5 edits, so this is
// ~100x fewer operations; measured 609M DP cells -> ~2M wavefront steps
// on the 60 Mb bench). State space is restricted to the same diagonal
// band [dlo, dhi], so the optimal cost (and the accept/reject decision)
// is identical to seg_align's; only tie-broken op order can differ.
// Falls back to seg_align when the wavefront depth exceeds WFA_DCAP
// (degenerate segments where the area DP is cheaper anyway).
// Depth cap before falling back to the area DP. Deep cores are real on
// repeat-bearing genomes: an overlap through a 90%-identity segmental
// repeat carries ~0.1 edits/base, so a 500-base core legitimately needs
// ~50 wavefronts — at the old cap of 48 nearly every such core paid the
// wavefront AND the full area DP (646M area cells vs 160M wavefront steps
// on the 60 Mb realistic bench). d*width stays below width*m until d ~ m,
// so the wavefront is the cheaper path essentially until the budget
// itself rejects the segment.
constexpr int32_t WFA_DCAP = 512;

struct WfaScratch {
    std::vector<int32_t> fr;      // (d+1) rows x width furthest-i
    std::vector<uint8_t> rops;
};
thread_local WfaScratch g_wfa;

int32_t wfa_seg(const uint8_t* t, int64_t n, const uint8_t* q, int64_t m,
                int64_t dlo, int64_t dhi, bool free_start, bool free_end,
                int32_t budget,
                uint8_t* ops_out, int64_t ops_cap, int64_t* len,
                int64_t* ts, int64_t* te)
{
    const int64_t width = dhi - dlo + 1;
    if (width <= 0) return -1;
    const int32_t dcap = budget;
    if (m * n <= 64) {
        // genuinely tiny segment: the area DP's whole matrix is fewer
        // cells than one wavefront setup. (A previous budget-based cutoff
        // here routed ~95% of all gap cores to the area DP — 727M area
        // cells vs 142M wavefront steps on the 60 Mb realistic bench —
        // because post-snake-trim cores are usually < 50 bases, exactly
        // where the d*width wavefront is ~20x cheaper than width*m.)
        return seg_align(t, n, q, m, dlo, dhi, free_start, free_end,
                         budget, ops_out, ops_cap, len, ts, te);
    }
    if (g_prof_on)
        g_stitch_prof[2].fetch_add(1, std::memory_order_relaxed);
    WfaScratch& s = g_wfa;
    constexpr int32_t NEG = INT32_MIN / 2;
    // scratch rows grow geometrically as the wavefront deepens: sizing
    // upfront for the full admission budget ((budget+1)*width) allocated
    // ~0.5 GB per DP thread on a megabase read whose wavefront the slope
    // abort ends after ~100 rows anyway
    int64_t fr_rows = (int64_t)dcap + 1 < 256 ? (int64_t)dcap + 1 : 256;
    if ((int64_t)s.fr.size() < fr_rows * width)
        s.fr.resize((size_t)(fr_rows * width));
    else
        fr_rows = (int64_t)s.fr.size() / width;
    int32_t* f0 = s.fr.data();

    // snake: advance i while in range and bases match (j = i + k);
    // 8 bases per compare via xor+ctz (snakes average ~1/error-rate bases,
    // and this loop is the wavefront's inner hot path)
    auto snake = [&](int64_t i, int64_t k) -> int64_t {
        const uint8_t* tp = t + k;
        const int64_t lim = m < n - k ? m : n - k;
        while (i + 8 <= lim) {
            uint64_t a, b;
            std::memcpy(&a, tp + i, 8);
            std::memcpy(&b, q + i, 8);
            const uint64_t x = a ^ b;
            if (x) return i + (__builtin_ctzll(x) >> 3);
            i += 8;
        }
        while (i < lim && tp[i] == q[i]) ++i;
        return i;
    };

    // d = 0 seeds: start at i=0, j=k (free start: any in-band j >= 0;
    // pinned: j == 0 only)
    const int64_t kend = n - m;              // pinned-end diagonal
    bool done = false;
    int64_t done_k = 0;
    int32_t done_d = 0;
    for (int64_t x = 0; x < width; ++x) f0[x] = NEG;
    if (free_start) {
        for (int64_t k = dlo < 0 ? 0 : dlo; k <= dhi && k <= n; ++k)
            f0[k - dlo] = (int32_t)snake(0, k);
    } else if (dlo <= 0 && 0 <= dhi) {
        f0[-dlo] = (int32_t)snake(0, 0);
    }
    auto at_end = [&](int64_t k, int32_t i) -> bool {
        if (i < m) return false;
        if (free_end) return m + k <= n;
        return k == kend;
    };
    for (int64_t x = 0; x < width; ++x)
        if (f0[x] >= 0 && at_end(x + dlo, f0[x])) {
            done = true; done_k = x + dlo; done_d = 0; break;
        }
    const int64_t absdn = n - m < 0 ? m - n : n - m;
    // active-lane range: the frontier can only grow one diagonal per
    // wavefront, so scanning the full band every wavefront wasted
    // ~width/d of the work on provably-NEG lanes (pinned-start gap cores
    // — the bulk of the ~900k segment calls per 60 Mb run — start from a
    // single diagonal). Two NEG sentinels are kept beyond each edge so
    // the next row's (and the traceback's) x+-1 reads stay defined.
    int64_t alo = 0, ahi = width - 1;
    if (!free_start) {
        if (dlo <= 0 && 0 <= dhi) alo = ahi = -dlo;
        else { alo = 0; ahi = -1; }   // no seed: same slope-abort path
    }
    int32_t d = 0;
    while (!done) {
        if (d >= dcap) return -1;    // budget exhausted: reject
        if ((int64_t)d + 1 >= fr_rows) {
            fr_rows = fr_rows * 2 < (int64_t)dcap + 1 ? fr_rows * 2
                                                      : (int64_t)dcap + 1;
            s.fr.resize((size_t)(fr_rows * width));
        }
        const int32_t* pv = s.fr.data() + (int64_t)d * width;
        int32_t* cv = s.fr.data() + (int64_t)(d + 1) * width;
        d += 1;
        const int64_t nlo = alo > 0 ? alo - 1 : 0;
        const int64_t nhi = ahi < width - 1 ? ahi + 1 : width - 1;
        if (g_prof_on)
            g_stitch_prof[3].fetch_add(nhi - nlo + 1,
                                       std::memory_order_relaxed);
        for (int64_t x = nlo - 2 > 0 ? nlo - 2 : 0; x < nlo; ++x)
            cv[x] = NEG;
        for (int64_t x = nhi + 1; x <= nhi + 2 && x < width; ++x)
            cv[x] = NEG;
        int32_t max_i = 0;
        for (int64_t x = nlo; x <= nhi; ++x) {
            const int64_t k = x + dlo;
            // candidates validity-checked (0 <= i <= m, j = i + k <= n);
            // NEG lanes fall through the comparisons and land below 0
            const int32_t ps = pv[x];                              // sub
            const int32_t pi = x + 1 < width ? pv[x + 1] : NEG;    // query-only
            const int32_t pd = x > 0 ? pv[x - 1] : NEG;            // target-only
            const int32_t c1 = (ps < m && ps + 1 + k <= n) ? ps + 1 : NEG;
            const int32_t c2 = pi < m ? pi + 1 : NEG;
            const int32_t c3 = pd + k <= n ? pd : NEG;
            int32_t best = c1 > c2 ? c1 : c2;
            if (c3 > best) best = c3;
            if (best < 0) { cv[x] = NEG; continue; }
            best = (int32_t)snake(best, k);
            cv[x] = best;
            if (best > max_i) max_i = best;
            if (!done && at_end(k, best)) { done = true; done_k = k; done_d = d; }
        }
        alo = nlo;
        ahi = nhi;
        // divergence-slope abort (the wavefront analog of ns_banded_align's):
        // a genuine overlap needs ~<0.2 edits per query base, a wrong-locus
        // core ~0.5 — without this, every divergent core walks the wavefront
        // to the full admission budget (d*width steps). |n-m| allows the
        // net-indel cost; 100 is burst headroom. Returns -2 (not -1): the
        // slope is wrong-locus evidence, so callers treat it as a final
        // verdict rather than a band/budget miss worth rescuing.
        if (!done && d > (int32_t)((7LL * max_i) / 20 + 100 + absdn))
            return -2;
    }

    // traceback through the stored wavefronts
    s.rops.clear();
    int64_t k = done_k;
    int64_t i = s.fr[(size_t)((int64_t)done_d * width + (k - dlo))];
    for (int32_t dd = done_d; dd > 0; --dd) {
        const int32_t* pv = s.fr.data() + (int64_t)(dd - 1) * width;
        const int64_t x = k - dlo;
        // same validity rules as the forward pass
        int32_t isub = NEG, iins = NEG, idel = NEG;
        const int32_t ps = pv[x];
        if (ps >= 0 && ps < m && ps + 1 + k <= n) isub = ps + 1;
        if (x + 1 < width) {
            const int32_t pi = pv[x + 1];
            if (pi >= 0 && pi < m) iins = pi + 1;
        }
        if (x > 0) {
            const int32_t pd = pv[x - 1];
            if (pd >= 0 && pd + k <= n) idel = pd;
        }
        int32_t i0 = isub;                   // prefer 's' (ratio: subs beat
        if (idel > i0) i0 = idel;            // indels in the edit streams)
        if (iins > i0) i0 = iins;
        for (int64_t y = i; y > i0; --y) s.rops.push_back('=');
        if (i0 == isub) {
            s.rops.push_back('s');
            i = isub - 1;
        } else if (i0 == idel) {
            s.rops.push_back('d');
            i = idel;
            k -= 1;
        } else {
            s.rops.push_back('i');
            i = iins - 1;
            k += 1;
        }
    }
    for (int64_t y = i; y > 0; --y) s.rops.push_back('=');
    const int64_t j0 = k;                    // start j at i == 0
    if (*len + (int64_t)s.rops.size() > ops_cap) return -1;
    for (int64_t x = (int64_t)s.rops.size() - 1; x >= 0; --x)
        ops_out[(*len)++] = s.rops[(size_t)x];
    *ts = j0;
    *te = free_end ? (m + done_k) : n;
    return done_d;
}

namespace {

// ---------------------------------------------------------------------------
// Second-round seeding for deep gap cores — the same idea as minimap2's
// re-seeding of long inter-anchor gaps (minimap2's role in the reference,
// SURVEY §2.3): a multi-kb gap between chain pins (typical when the chain
// skips a divergent segmental repeat) would otherwise pay d*width wavefront
// steps AND often a width*m area-DP fallback (~0.8M cells per core; ~500
// such cores accounted for most of the stitch time on the 60 Mb realistic
// bench). Exact 16-mer matches inside the core re-pin it, and the small
// sub-gaps go back to the wavefront.
// ---------------------------------------------------------------------------
constexpr int64_t CORE_RESEED_CELLS = 16384; // re-anchor cores above this
constexpr int CORE_K = 16;                   // seed length (exact 32-bit kmer)

struct CoreScratch {
    std::vector<uint32_t> key;
    std::vector<int32_t> val;      // 0 empty, -1 ambiguous, else qpos+1
    std::vector<int64_t> mq, mt;
    std::vector<int32_t> cf;
    std::vector<int64_t> cpar, cq2, ct2;
};
thread_local CoreScratch g_cs;

// Aligns q[0..m) to t[0..n) with the given end freedoms, diagonal band
// [dlo, dhi]. Appends ops at *len. Returns cost >= 0; -1 reject (budget);
// -3 = no usable internal pins, caller should run the plain wavefront.
int32_t core_align(const uint8_t* t, int64_t n, const uint8_t* q, int64_t m,
                   int64_t dlo, int64_t dhi, bool free_start, bool free_end,
                   int32_t budget,
                   uint8_t* ops_out, int64_t ops_cap, int64_t* len,
                   int64_t* ts, int64_t* te)
{
    if (m < 3 * CORE_K || n < 3 * CORE_K) return -3;
    g_core_prof[0].fetch_add(1, std::memory_order_relaxed);
    CoreScratch& s = g_cs;
    // query 16-mer table (open addressing, power-of-two size); ambiguous
    // (repeated) k-mers are dropped — a repeat seed would mis-pin exactly
    // the cores this path exists for
    int64_t cap = 1;
    while (cap < 2 * (m - CORE_K + 1)) cap <<= 1;
    if ((int64_t)s.key.size() < cap) { s.key.resize((size_t)cap); }
    s.val.assign((size_t)cap, 0);
    const uint64_t hmul = 0x9E3779B97F4A7C15ULL;
    uint32_t km = 0;
    for (int64_t i = 0; i < m; ++i) {
        km = (km << 2) | q[i];
        if (i < CORE_K - 1) continue;
        const int64_t qp = i - (CORE_K - 1);
        uint64_t h = ((uint64_t)km * hmul) >> 32;
        int64_t x = (int64_t)(h & (uint64_t)(cap - 1));
        while (true) {
            if (s.val[(size_t)x] == 0) {
                s.key[(size_t)x] = km;
                s.val[(size_t)x] = (int32_t)qp + 1;
                break;
            }
            if (s.key[(size_t)x] == km) {
                s.val[(size_t)x] = -1;
                break;
            }
            x = (x + 1) & (cap - 1);
        }
    }
    // scan target, collect in-band unambiguous matches (sorted by tp)
    s.mq.clear();
    s.mt.clear();
    km = 0;
    for (int64_t j = 0; j < n; ++j) {
        km = (km << 2) | t[j];
        if (j < CORE_K - 1) continue;
        const int64_t tp = j - (CORE_K - 1);
        uint64_t h = ((uint64_t)km * hmul) >> 32;
        int64_t x = (int64_t)(h & (uint64_t)(cap - 1));
        while (s.val[(size_t)x] != 0) {
            if (s.key[(size_t)x] == km) {
                if (s.val[(size_t)x] > 0) {
                    const int64_t qp = s.val[(size_t)x] - 1;
                    const int64_t diag = tp - qp;
                    if (diag >= dlo && diag <= dhi) {
                        s.mq.push_back(qp);
                        s.mt.push_back(tp);
                    }
                }
                break;
            }
            x = (x + 1) & (cap - 1);
        }
    }
    const int64_t F = (int64_t)s.mq.size();
    if (F < 1) { g_core_prof[3].fetch_add(1, std::memory_order_relaxed); return -3; }
    // bounded-lookback monotone chain (the main stitch chain's rules;
    // pins must clear each other by CORE_K so each contributes CORE_K '=')
    constexpr int64_t JUMP_MAX = 64, LOOKBACK = 32;
    s.cf.assign((size_t)F, 1);
    s.cpar.assign((size_t)F, -1);
    int64_t best_i = 0;
    for (int64_t i = 1; i < F; ++i) {
        const int64_t lo = i - LOOKBACK < 0 ? 0 : i - LOOKBACK;
        const int64_t di = s.mt[(size_t)i] - s.mq[(size_t)i];
        for (int64_t j = i - 1; j >= lo; --j) {
            if (s.cf[(size_t)j] + 1 <= s.cf[(size_t)i]) continue;
            if (s.mq[(size_t)j] + CORE_K > s.mq[(size_t)i]) continue;
            if (s.mt[(size_t)j] + CORE_K > s.mt[(size_t)i]) continue;
            const int64_t dj = s.mt[(size_t)j] - s.mq[(size_t)j];
            if (di - dj > JUMP_MAX || dj - di > JUMP_MAX) continue;
            s.cf[(size_t)i] = s.cf[(size_t)j] + 1;
            s.cpar[(size_t)i] = j;
        }
        if (s.cf[(size_t)i] > s.cf[(size_t)best_i]) best_i = i;
    }
    s.cq2.clear();
    s.ct2.clear();
    for (int64_t x = best_i; x >= 0; x = s.cpar[(size_t)x]) {
        s.cq2.push_back(s.mq[(size_t)x]);
        s.ct2.push_back(s.mt[(size_t)x]);
        if (s.cpar[(size_t)x] < 0) break;
    }
    std::reverse(s.cq2.begin(), s.cq2.end());
    std::reverse(s.ct2.begin(), s.ct2.end());
    const int64_t C = (int64_t)s.cq2.size();
    if (C < 1) { g_core_prof[3].fetch_add(1, std::memory_order_relaxed); return -3; }

    int32_t cost = 0;
    int64_t pq = 0, pt = 0;      // consumed prefix (query, target)
    const int64_t len0 = *len;   // restored on any failure so the caller's
                                 // fallback path appends to a clean buffer
    *ts = 0;
    *te = n;
    for (int64_t x = 0; x <= C; ++x) {
        const int64_t gq_end = x < C ? s.cq2[(size_t)x] : m;
        const int64_t gt_end = x < C ? s.ct2[(size_t)x] : n;
        const int64_t gq = gq_end - pq, gt = gt_end - pt;
        if (gq < 0 || gt < 0) { *len = len0; return -3; }
        if (gq > 0 || gt > 0) {
            const int64_t dn = gt - gq;
            const int64_t pad =
                std::min<int64_t>(128, 4 + (gq > gt ? gq : gt) / 24);
            int64_t sts = 0, ste = 0;
            const bool fs = free_start && x == 0;
            const bool fe = free_end && x == C;
            const int32_t c1 = wfa_seg(
                t + pt, gt, q + pq, gq,
                (dn < 0 ? dn : 0) - pad, (dn > 0 ? dn : 0) + pad,
                fs, fe, budget - cost, ops_out, ops_cap, len, &sts, &ste);
            if (c1 < 0) {
                // propagate the wavefront's verdict (-2 divergence is
                // final for the caller; -1 band/budget is rescuable)
                *len = len0;
                g_core_prof[2].fetch_add(1, std::memory_order_relaxed);
                return c1;
            }
            cost += c1;
            if (fs) *ts = sts;
            if (fe) *te = pt + ste;
        }
        if (x < C) {
            if (*len + CORE_K > ops_cap) { *len = len0; return -1; }
            std::memset(ops_out + *len, '=', CORE_K);
            *len += CORE_K;
            pq = gq_end + CORE_K;
            pt = gt_end + CORE_K;
        }
    }
    g_core_prof[1].fetch_add(1, std::memory_order_relaxed);
    return cost;
}

}  // namespace

int32_t ns_stitch_align(
    const uint8_t* t, int64_t n, const uint8_t* q, int64_t m,
    const int64_t* aq, const int64_t* at, int64_t A,
    int64_t d0, int32_t W, int32_t Wmax, int32_t max_cost,
    uint8_t* ops_out, int64_t ops_cap, int64_t* ops_len,
    int64_t* tstart_out, int64_t* tend_out)
{
    if (Wmax < W) Wmax = W;
    constexpr int64_t JUMP_MAX = 64;    // max diag shift between pins
    constexpr int64_t LOOKBACK = 32;    // chain-DP lookback bound
    constexpr int32_t SUB_MAX = 3;      // mismatches tolerated per run
                                        // before the segment is DP'd
    // in-band candidate pins
    std::vector<int64_t> fq_, ft_;
    fq_.reserve((size_t)A);
    ft_.reserve((size_t)A);
    for (int64_t x = 0; x < A; ++x) {
        const int64_t qx = aq[x], tx = at[x];
        if (qx < 0 || qx >= m || tx < 0 || tx >= n) continue;
        const int64_t diag = tx - qx;
        if (diag < d0 - W || diag > d0 + W) continue;
        fq_.push_back(qx);
        ft_.push_back(tx);
    }
    const int64_t F = (int64_t)fq_.size();
    if (g_prof_on) {
        g_stitch_prof[0].fetch_add(1, std::memory_order_relaxed);
        g_stitch_prof[6].fetch_add(A, std::memory_order_relaxed);
    }
    if (F < 2) { g_stitch_stats[0]++; return -4; }
    // longest monotone chain with bounded diagonal jumps (the greedy
    // keep-first rule let one outlier pin poison the whole chain; this is
    // the O(F * lookback) analog of minimap2's chain DP, minimap2/chain.c)
    std::vector<int32_t> f((size_t)F, 1);
    std::vector<int64_t> par((size_t)F, -1);
    int64_t best_i = 0;
    for (int64_t i = 1; i < F; ++i) {
        const int64_t lo = i - LOOKBACK < 0 ? 0 : i - LOOKBACK;
        const int64_t di = ft_[(size_t)i] - fq_[(size_t)i];
        for (int64_t j = i - 1; j >= lo; --j) {
            if (f[(size_t)j] + 1 <= f[(size_t)i]) continue;
            if (fq_[(size_t)j] >= fq_[(size_t)i]) continue;
            if (ft_[(size_t)j] >= ft_[(size_t)i]) continue;
            const int64_t dj = ft_[(size_t)j] - fq_[(size_t)j];
            if (di - dj > JUMP_MAX || dj - di > JUMP_MAX) continue;
            f[(size_t)i] = f[(size_t)j] + 1;
            par[(size_t)i] = j;
        }
        if (f[(size_t)i] > f[(size_t)best_i]) best_i = i;
    }
    std::vector<int64_t> cq, ct;
    cq.reserve((size_t)f[(size_t)best_i]);
    ct.reserve((size_t)f[(size_t)best_i]);
    for (int64_t x = best_i; x >= 0; x = par[(size_t)x]) {
        cq.push_back(fq_[(size_t)x]);
        ct.push_back(ft_[(size_t)x]);
        if (par[(size_t)x] < 0) break;
    }
    std::reverse(cq.begin(), cq.end());
    std::reverse(ct.begin(), ct.end());
    const int64_t C = (int64_t)cq.size();
    if (g_prof_on)
        g_stitch_prof[4].fetch_add(C, std::memory_order_relaxed);
    if (C < 2) { g_stitch_stats[1]++; return -4; }

    int64_t len = 0;
    int32_t cost = 0;
    int64_t tstart = ct.front();
    int64_t tend = ct.back();

    // Gap-segment policy (round-4 bench: stitch rejects fed a full-band
    // re-queue that was 73% of DP wall for 10.5% of bases, and 73% of the
    // escalated pairs rejected AGAIN after paying band*len cells):
    //   - core_align handles big segments; any failure falls through to
    //     the chain-free wavefront, whose verdict is authoritative
    //     (core's internal 16-mer chain can mis-pin inside repeats, so
    //     its budget rejects are not final; measured: ~100 pairs per
    //     60 Mb bench accept here that used to need the full-band
    //     escalation).
    //   - the wavefront distinguishes WHY it failed: -2 = divergence
    //     slope abort (wrong-locus evidence -> the pair is rejected for
    //     good and the engine skips the full-band escalation), -1 =
    //     band/budget pressure (a wider band may fix it -> pad rescue
    //     here, then pin backoff, then the engine escalation).
    //   - pad rescue: retry the segment with the pad widened to Wmax
    //     (the escalation band). pin backoff: head/tail failures drop up
    //     to BACKOFF_MAX outermost pins (mis-pinned chain ends).
    // In-place rescues count g_stitch_stats[7] ("rescued").
    constexpr int64_t BACKOFF_MAX = 2;
    const auto run_gap = [&](const uint8_t* ts, int64_t ns, const uint8_t* qs,
                             int64_t ms, int64_t dlo, int64_t dhi, bool fs,
                             bool fe, int64_t* sts, int64_t* ste) -> int32_t {
        int32_t c1 = -3;
        if (ms * ns >= CORE_RESEED_CELLS)
            c1 = core_align(ts, ns, qs, ms, dlo, dhi, fs, fe,
                            max_cost - cost, ops_out, ops_cap, &len, sts, ste);
        if (c1 == -2) return -2;     // core sub-gap hit the slope abort
        if (c1 < 0)
            c1 = wfa_seg(ts, ns, qs, ms, dlo, dhi, fs, fe,
                         max_cost - cost, ops_out, ops_cap, &len, sts, ste);
        return c1;
    };

    // head: free target start, pinned end at (cq[lo_pin], ct[lo_pin])
    int64_t lo_pin = 0;
    if (cq.front() > 0) {
        int32_t c1 = -1;
        int64_t sts = 0, ts0 = 0;
        int64_t tries = 0;
        for (;;) {
            const int64_t hq = cq[(size_t)lo_pin];
            const int64_t tpin = ct[(size_t)lo_pin];
            const int64_t pad =
                std::min<int64_t>(tries ? Wmax : W, 8 + hq / 8);
            ts0 = std::max<int64_t>(0, tpin - hq - pad);
            const int64_t n1 = tpin - ts0;
            // if the query head overhangs the target start (n1 < hq), the
            // path climbs j == 0 with leading inserts
            int64_t ste = 0;
            c1 = run_gap(t + ts0, n1, q, hq,
                         (n1 - hq) - pad, std::max<int64_t>(0, n1 - hq) + pad,
                         /*fs=*/true, /*fe=*/false, &sts, &ste);
            if (c1 >= 0) {
                if (tries) g_stitch_stats[7]++;
                break;
            }
            if (c1 == -1 && tries == 0 &&
                std::min<int64_t>(Wmax, 8 + hq / 8) > pad) {
                tries = 1;           // pad rescue at the escalation band
                continue;
            }
            if (c1 == -1 && tries <= BACKOFF_MAX &&
                lo_pin < BACKOFF_MAX && C - 1 - (lo_pin + 1) >= 1) {
                lo_pin += 1;         // drop a possibly mis-pinned first pin
                tries += 1;
                continue;
            }
            g_stitch_stats[2]++;
            stitch_dump(t, n, q, m, aq, at, A, d0, W, max_cost, 2);
            return c1 == -2 ? -2 : -1;
        }
        cost += c1;
        tstart = ts0 + sts;
    }

    // middles between consecutive pins [lo_pin..hi_pin]; pin-boundary
    // prefix state (len, cost) is recorded so a tail backoff can undo the
    // final middle segment when it drops the last pin
    std::vector<int64_t> pref_len((size_t)C, 0);
    std::vector<int32_t> pref_cost((size_t)C, 0);
    int64_t hi_pin = C - 1;
    for (int64_t x = lo_pin + 1; x <= hi_pin; ++x) {
        pref_len[(size_t)x] = len;
        pref_cost[(size_t)x] = cost;
        const int64_t q0 = cq[(size_t)x - 1], q1 = cq[(size_t)x];
        const int64_t t0 = ct[(size_t)x - 1], t1 = ct[(size_t)x];
        const int64_t mq = q1 - q0, mt = t1 - t0;
        if (mq == mt) {
            // same diagonal: verify as a substitution run
            const uint8_t* tp = t + t0;
            const uint8_t* qp = q + q0;
            int32_t mc = 0;
            if (g_prof_on)
                g_stitch_prof[1].fetch_add(mq, std::memory_order_relaxed);
            for (int64_t y = 0; y < mq; ++y) mc += (int32_t)(tp[y] != qp[y]);
            if (mc <= SUB_MAX) {
                if (len + mq > ops_cap) return -1;
                for (int64_t y = 0; y < mq; ++y)
                    ops_out[len++] = tp[y] == qp[y] ? '=' : 's';
                cost += mc;
                if (cost > max_cost) return -1;
                continue;
            }
        }
        // greedy snake trim (exact for unit costs: matching symbols at a
        // pinned end can always begin/end an optimal alignment), then DP
        // only the core around the indel/mismatch cluster
        const uint8_t* tp = t + t0;
        const uint8_t* qp = q + q0;
        int64_t pre = 0;
        while (pre < mq && pre < mt && qp[pre] == tp[pre]) ++pre;
        int64_t suf = 0;
        const int64_t lim = std::min(mq, mt) - pre;
        while (suf < lim && qp[mq - 1 - suf] == tp[mt - 1 - suf]) ++suf;
        const int64_t cq1 = mq - pre - suf, ct1 = mt - pre - suf;
        if (len + pre + suf > ops_cap) return -1;
        for (int64_t y = 0; y < pre; ++y) ops_out[len++] = '=';
        if (cq1 > 0 || ct1 > 0) {
            const int64_t dn = ct1 - cq1;
            int32_t c1 = -1;
            for (int rescue = 0; rescue < 2; ++rescue) {
                const int64_t pad = std::min<int64_t>(
                    rescue ? Wmax : W, 4 + std::max(cq1, ct1) / 24);
                int64_t sts = 0, ste = 0;
                c1 = run_gap(tp + pre, ct1, qp + pre, cq1,
                             std::min<int64_t>(0, dn) - pad,
                             std::max<int64_t>(0, dn) + pad,
                             /*fs=*/false, /*fe=*/false, &sts, &ste);
                if (c1 >= 0) {
                    if (rescue) g_stitch_stats[7]++;
                    break;
                }
                if (c1 == -2) break;   // diverged: rescue cannot help
                if (rescue == 0 &&
                    std::min<int64_t>(Wmax, 4 + std::max(cq1, ct1) / 24) <=
                        std::min<int64_t>(W, 4 + std::max(cq1, ct1) / 24))
                    break;  // pad already length-capped below W
            }
            if (c1 < 0) {
                g_stitch_stats[3]++;
                return c1 == -2 ? -2 : -1;
            }
            cost += c1;
        }
        if (len + suf > ops_cap) return -1;
        for (int64_t y = 0; y < suf; ++y) ops_out[len++] = '=';
    }

    // tail: pinned start at the last kept pin, free target end
    tend = ct[(size_t)hi_pin];
    if (m - cq[(size_t)hi_pin] > 0) {
        int32_t c1 = -1;
        int64_t ste_keep = 0;
        int64_t tries = 0, backoffs = 0;
        for (;;) {
            const int64_t tq = m - cq[(size_t)hi_pin];
            const int64_t qpin = cq[(size_t)hi_pin];
            const int64_t tpin = ct[(size_t)hi_pin];
            const int64_t pad =
                std::min<int64_t>(tries ? Wmax : W, 8 + tq / 8);
            const int64_t n1 = std::min(n, tpin + tq + pad) - tpin;
            // if the query tail overhangs the target end (n1 < tq), the
            // path descends j == n1 with trailing inserts
            int64_t sts = 0, ste = 0;
            c1 = run_gap(t + tpin, n1, q + qpin, tq,
                         std::min<int64_t>(0, n1 - tq) - pad, pad,
                         /*fs=*/false, /*fe=*/true, &sts, &ste);
            if (c1 >= 0) {
                ste_keep = ste;
                if (tries) g_stitch_stats[7]++;
                break;
            }
            if (c1 == -1 && tries == 0 &&
                std::min<int64_t>(Wmax, 8 + tq / 8) > pad) {
                tries = 1;           // pad rescue at the escalation band
                continue;
            }
            if (c1 == -1 && backoffs < BACKOFF_MAX && hi_pin - 1 > lo_pin) {
                // drop a possibly mis-pinned last pin: rewind the middle
                // segment that ended at it, then retry the larger tail
                len = pref_len[(size_t)hi_pin];
                cost = pref_cost[(size_t)hi_pin];
                hi_pin -= 1;
                backoffs += 1;
                tries += 1;
                continue;
            }
            g_stitch_stats[4]++;
            stitch_dump(t, n, q, m, aq, at, A, d0, W, max_cost, 4);
            return c1 == -2 ? -2 : -1;
        }
        cost += c1;
        tend = ct[(size_t)hi_pin] + ste_keep;
    }
    if (cost > max_cost) { g_stitch_stats[5]++; return -1; }
    g_stitch_stats[6]++;
    *ops_len = len;
    *tstart_out = tstart;
    *tend_out = tend;
    return cost;
}

// NS_ENGINE_DEBUG diagnostics for the stitched path.
void ns_stitch_stats(int64_t* out8)
{
    for (int i = 0; i < 8; ++i) out8[i] = g_stitch_stats[i].load();
}

// Zero the stitch/core profile counters (called at engine-run start so
// NS_ENGINE_DEBUG prints per-run numbers, not process-cumulative ones).
void ns_stitch_stats_reset()
{
    for (int i = 0; i < 8; ++i) g_stitch_stats[i] = 0;
    for (int i = 0; i < 8; ++i) g_stitch_prof[i] = 0;
    for (int i = 0; i < 8; ++i) g_core_prof[i] = 0;
}

// Chain-free full-window aligner on the wavefront core: same diagonal
// band [d0-W, d0+W], same unit costs, and free target start/end as
// ns_banded_align — so the optimal cost and the accept/reject verdict
// are identical — but the work scales with edits*band + snake bytes/8
// instead of band*len cells. This is the engine's full-band escalation
// tier (round-4 bench: the area DP there was 73% of DP wall for 10.5%
// of bases, with 73% of escalated pairs rejecting again after paying
// band*len; the wavefront's divergence-slope abort ends those rejects
// at a few hundred wavefronts instead). Reference role: the escalation
// replaces minimap2's ksw_extz2_sse full-extension fallback
// (minimap2/align.c:329).
int32_t ns_wfa_align(
    const uint8_t* target, int64_t n,
    const uint8_t* query, int64_t m,
    int64_t d0, int32_t W, int32_t max_cost,
    uint8_t* ops_out, int64_t ops_cap, int64_t* ops_len,
    int64_t* tstart_out, int64_t* tend_out)
{
    *ops_len = 0;
    return wfa_seg(target, n, query, m, d0 - W, d0 + W,
                   /*free_start=*/true, /*free_end=*/true, max_cost,
                   ops_out, ops_cap, ops_len, tstart_out, tend_out);
}

void ns_stitch_prof(int64_t* out8)
{
    for (int i = 0; i < 8; ++i) out8[i] = g_stitch_prof[i].load();
}

void ns_core_prof(int64_t* out8)
{
    for (int i = 0; i < 8; ++i) out8[i] = g_core_prof[i].load();
}

// Batch interface: pairs share flat code buffers. Returns number of pairs
// processed. Per-pair outputs: cost (or -1), ops in ops_flat at
// ops_off[p] with length ops_len[p], tstart/tend.
void ns_banded_align_batch(
    const uint8_t* targets_flat, const int64_t* t_off, const int64_t* t_len,
    const uint8_t* queries_flat, const int64_t* q_off, const int64_t* q_len,
    const int64_t* d0s, int32_t W, int32_t max_cost_per_kb,
    int64_t npairs,
    uint8_t* ops_flat, const int64_t* ops_off, int64_t ops_cap_each,
    int64_t* ops_len, int64_t* tstart, int64_t* tend, int32_t* cost)
{
    // Scratch is thread_local, so pairs parallelize cleanly. Dynamic
    // schedule: pair cost varies with query length and early aborts.
    #pragma omp parallel for schedule(dynamic, 4)
    for (int64_t p = 0; p < npairs; ++p) {
        int64_t m = q_len[p];
        int32_t max_cost = (int32_t)((m * (int64_t)max_cost_per_kb) / 1000 + 8);
        cost[p] = ns_banded_align(
            targets_flat + t_off[p], t_len[p],
            queries_flat + q_off[p], m,
            d0s[p], W, max_cost,
            ops_flat + ops_off[p], ops_cap_each, &ops_len[p],
            &tstart[p], &tend[p]);
        if (cost[p] < 0) { ops_len[p] = 0; tstart[p] = 0; tend[p] = 0; }
    }
}

}  // extern "C"
