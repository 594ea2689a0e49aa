// Fused segment scan for Hopper (sm_90a): the whole sequential-greedy
// filter -> score -> selectHost -> commit loop over one segment's pods in a
// single persistent thread-block cluster.
//
// Replaces the JAX package's fused Pallas kernel
// (kubernetes_tpu/ops/pallas_kernel.py::_pallas_runner -> kernel). The plain
// version it is held against is kubernetes_tpu_torch/ops/scan_ref.py; both
// compute every score in int64 with floor division, lane for lane.
//
// Design. One cluster of `cs` blocks (cs = ceil(N / 1024), at most 8, one
// block of 1024 threads per SM) runs the pods in order. Column round `c` of
// thread `tid` in cluster rank `r` is node (c*cs + r)*1024 + tid: up to 8192
// nodes every thread owns one column, and every warp-wide load of a
// node-axis plane is one coalesced request. A column's state is read and
// written only by the block that owns it, so the mutable state planes live
// in global memory (a few MB at 5k nodes, resident in the 50 MB L2) with no
// cross-SM traffic; blocks exchange only per-pod scalars through
// distributed shared memory. Per pod:
//   1. the pod's signature row (requests, ports, active terms, volume
//      slots) is loaded into shared memory by plain indexed loads;
//   2. each thread evaluates feasibility and the raw score inputs for its
//      columns; ONE combined reduction (block, then the cluster's blocks)
//      yields n_feasible, the per-zone spread sums, and the
//      affinity/taint/interpod extrema;
//   3. each thread finishes its columns' totals; a cluster max gives the
//      best score. Ties are recorded as one ballot per (round, warp); node
//      order is (round, rank, warp, lane), so a scan over the per-(round,
//      rank) tie counts finds the block holding the (rr % ties + 1)-th tie,
//      and every block decodes the same node from that block's ballots;
//   4. the owners commit the chosen column, and every block the
//      same-domain columns of the pod's terms that it owns.
// Three cluster barriers per pod order the exchanges.
// What bounds it: one pod at a time, so the work per pod (about 25 int32
// loads and ~100 integer operations per feasible column, spread over up to
// 8 SMs) and the barriers' latency; the card's other SMs idle.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 1024;
constexpr int NWARPS = BLOCK / 32;
constexpr int MAX_CLUSTER = 8;  // the portable thread-block cluster size
constexpr int MAX_CPT = 16;
constexpr int MAX_ZONES = 8;
constexpr int MAX_TERMS = 128;
constexpr int MAX_PORTS = 256;
constexpr int MAX_SLOTS = 8;
constexpr int MAX_KINDS = 4;
constexpr int MAX_R = 8;
constexpr int NRED = 15;  // combined reduction slots, see reduce_all
constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_PRIORITY = 10;
constexpr long long FP_ONE = 1024;
constexpr long long FP = MAX_PRIORITY * FP_ONE;
constexpr long long I64_MIN = (long long)(-9223372036854775807LL - 1);
constexpr long long I64_MAX = 9223372036854775807LL;

}  // namespace

extern "C" {

struct ScanParams {
    // static node-axis planes (row-major, rows contiguous over nodes)
    const int32_t* alloc;         // [R, N]
    const int32_t* alloc_pods;    // [N]
    const int32_t* exists;        // [N]
    const int32_t* zone;          // [N], -1 = no zone
    const int32_t* static_ok;     // [G, N]
    const int32_t* aff_raw;       // [G, N]
    const int32_t* taint_raw;     // [G, N]
    const int32_t* score_raw;     // [G, N]
    const int32_t* interpod_raw;  // [G, N]
    const int32_t* node_domain;   // [T, N]
    const int32_t* dom_valid;     // [T, N]
    // per-signature tables
    const int32_t* g_request;     // [G, R]
    const int32_t* g_nonzero;     // [G, 2]
    const int32_t* g_ports;       // [G, Pv]
    const int32_t* g_has_spread;  // [G]
    const int32_t* spread_inc_t;  // [G, G]: row h = increments when sig h lands
    const int32_t* term_list;     // [G, T]: active terms of sig g first
    const int32_t* term_count;    // [G]
    const int32_t* tm_t;          // [G, T] sig g in term t's scope
    const int32_t* own_w;         // [G, T]
    const int32_t* own_ra;        // [G, T]
    const int32_t* own_raa;       // [G, T]
    const int32_t* own_all;       // [G, T]
    const int32_t* sym_w;         // [T]
    const int32_t* is_raa;        // [T]
    const int32_t* self_match;    // [T]
    const int32_t* vol_limits;    // [K]
    // per pod
    const int32_t* gids;          // [P]
    const int32_t* pod_vol;       // [P, W]: vid*64 | kind*8 | ro*4 | count_only*2 | valid
    // mutable state (working copies, updated in place)
    int32_t* req;                 // [R, N]
    int32_t* nz;                  // [2, N]
    int32_t* cnt;                 // [N]
    int32_t* ports;               // [Pv, N]
    int32_t* spread;              // [G, N]
    int32_t* dm;                  // [T, N]
    int32_t* downer;              // [T, N]
    int32_t* total;               // [T]
    uint8_t* volf;                // [V, N]: bit 0 any instance, bit 1 non-sharable
    int32_t* nk;                  // [K, N]
    // outputs
    int32_t* chosen;              // [P]
    int32_t* rr_out;              // [1]
    // sizes and flags
    int32_t n, g, t, pv, v, r, w, k, p_real, num_zones, rr0;
    int32_t use_terms, use_vols, use_ports;
    int32_t wt[7];  // least, most, balanced, spread, node_affinity, taint, interpod
};

}  // extern "C"

namespace {

__device__ __forceinline__ long long floordiv(long long a, long long b) {
    long long q = a / b;
    long long r = a - q * b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ long long usage(long long req, long long cap, bool most) {
    long long safe = cap > 1 ? cap : 1;
    long long raw = most ? floordiv(req * MAX_PRIORITY, safe)
                         : floordiv((cap - req) * MAX_PRIORITY, safe);
    return (cap == 0 || req > cap) ? 0 : raw;
}

// Reduction slots: 0 n_feasible, 1..8 zone sums, 9 feasible-with-zone count
// (sums); 10 spread max, 11 node-affinity max, 12 taint max, 13 interpod
// max (maxima); 14 interpod min (minimum).
__device__ __forceinline__ long long combine(int s, long long a, long long b) {
    if (s < 10) return a + b;
    if (s < 14) return a > b ? a : b;
    return a < b ? a : b;
}

__device__ __forceinline__ long long identity(int s) {
    return s == 13 ? I64_MIN : (s == 14 ? I64_MAX : 0);
}

// Zone slots past the segment's zone count are skipped; their outputs are
// never read.
__device__ __forceinline__ bool unused_slot(int s, int nzones) {
    return s > nzones && s <= MAX_ZONES;
}

__device__ __forceinline__ long long warp_combine(int s, long long x) {
#pragma unroll
    for (int off = 16; off; off >>= 1) x = combine(s, x, __shfl_xor_sync(FULL, x, off));
    return x;
}

// Every slot of v reduced over the cluster into out. Warp s reduces slot s,
// first over the block's warps, then over the cluster's blocks (the
// partials are read from the other blocks' shared memory after a cluster
// barrier).
__device__ void reduce_all(cg::cluster_group& cluster, long long (&v)[NRED], long long* sh,
                           long long* part, long long* out, int nzones) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cs = static_cast<int>(cluster.num_blocks());
#pragma unroll
    for (int s = 0; s < NRED; ++s) {
        if (unused_slot(s, nzones)) continue;
        const long long x = warp_combine(s, v[s]);
        if (lane == 0) sh[warp * NRED + s] = x;
    }
    __syncthreads();
    const bool mine = warp < NRED && !unused_slot(warp, nzones);
    if (mine) {
        const long long x = warp_combine(warp, sh[lane * NRED + warp]);
        if (lane == 0) part[warp] = x;
    }
    cluster.sync();
    if (mine) {
        const long long x = lane < cs ? *cluster.map_shared_rank(&part[warp], lane) : identity(warp);
        const long long y = warp_combine(warp, x);
        if (lane == 0) out[warp] = y;
    }
    __syncthreads();
}

// Block-wide exclusive prefix of per-thread counts in thread order; returns
// the prefix and writes the block total to *total.
__device__ int block_exclusive_scan(int c, int* sh, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int x = sh[lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            int y = __shfl_up_sync(FULL, x, off);
            if (lane >= off) x += y;
        }
        sh[lane] = x;  // inclusive warp-total prefix
    }
    __syncthreads();
    *total = sh[NWARPS - 1];
    return incl - c + (warp > 0 ? sh[warp - 1] : 0);
}

template <int CPT>
__global__ void __launch_bounds__(BLOCK, 1) fused_scan_kernel(const ScanParams p) {
    cg::cluster_group cluster = cg::this_cluster();
    // read by the cluster's other blocks: s_part, s_bmax, s_bal, s_rt
    __shared__ long long s_red[NWARPS * NRED];
    __shared__ long long s_part[NRED];
    __shared__ long long s_out[NRED];
    __shared__ long long s_wmax[NWARPS];
    __shared__ long long s_bmax;
    __shared__ long long s_gmax;
    __shared__ int s_scan[NWARPS];
    __shared__ unsigned s_bal[MAX_CPT * NWARPS];  // tie ballot per (round, warp)
    __shared__ int s_rt[MAX_CPT];                 // ties per round in this block
    __shared__ int s_pick[2];                     // (round, rank) slot, rank in it
    __shared__ int s_total[MAX_TERMS];            // this block's copy of total_match
    __shared__ int s_greq[MAX_R];
    __shared__ int s_gnz[2];
    __shared__ int s_gports[MAX_PORTS];
    __shared__ int s_tidx[MAX_TERMS];
    __shared__ int s_mg[MAX_TERMS];
    __shared__ int s_ra[MAX_TERMS];
    __shared__ int s_raa[MAX_TERMS];
    __shared__ int s_all[MAX_TERMS];
    __shared__ int s_ownw[MAX_TERMS];
    __shared__ int s_symw[MAX_TERMS];   // m_g * sym_w
    __shared__ int s_symraa[MAX_TERMS]; // m_g && is_raa
    __shared__ int s_firstok[MAX_TERMS];
    __shared__ int s_vol[MAX_SLOTS];
    __shared__ int s_chosen;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cs = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int N = p.n, R = p.r, T = p.t, G = p.g, PV = p.pv, W = p.w, K = p.k;
    long long rr = p.rr0;
    for (int t = tid; t < T; t += BLOCK) s_total[t] = p.total[t];
    cluster.sync();  // every block runs before any reads another's shared memory

    for (int i = 0; i < p.p_real; ++i) {
        const int gid = p.gids[i];
        const int tcount = p.use_terms ? p.term_count[gid] : 0;
        // ---- 1. the pod's signature row into shared memory ----
        if (tid < R) s_greq[tid] = p.g_request[gid * R + tid];
        if (tid < 2) s_gnz[tid] = p.g_nonzero[gid * 2 + tid];
        if (p.use_ports && tid < PV) s_gports[tid] = p.g_ports[gid * PV + tid];
        if (tid < tcount) {
            const int t = p.term_list[gid * T + tid];
            const int mg = p.tm_t[gid * T + t];
            s_tidx[tid] = t;
            s_mg[tid] = mg;
            s_ra[tid] = p.own_ra[gid * T + t];
            s_raa[tid] = p.own_raa[gid * T + t];
            s_all[tid] = p.own_all[gid * T + t];
            s_ownw[tid] = p.own_w[gid * T + t];
            s_symw[tid] = mg ? p.sym_w[t] : 0;
            s_symraa[tid] = mg && p.is_raa[t];
            s_firstok[tid] = (s_total[t] == 0) && p.self_match[t];
        }
        if (p.use_vols && tid < W) s_vol[tid] = p.pod_vol[i * W + tid];
        __syncthreads();

        // ---- 2. feasibility and raw score inputs per owned column ----
        bool feas[CPT];
        long long ip[CPT];
        long long red[NRED];
#pragma unroll
        for (int s = 0; s < NRED; ++s) red[s] = identity(s);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int j = (c * cs + rank) * BLOCK + tid;
            bool f = false;
            ip[c] = 0;
            // the filter's loads do not wait on one another's verdicts:
            // each check folds into `f`
            if (j < N) {
                const int ex = p.exists[j], ok = p.static_ok[gid * N + j];
                const int cnt = p.cnt[j], cap = p.alloc_pods[j];
                f = ex && ok && cnt + 1 <= cap;
            }
            if (f) {
                for (int r = 0; r < R; ++r) {
                    const int gr = s_greq[r];
                    if (gr > 0) f &= (long long)p.req[r * N + j] + gr <= p.alloc[r * N + j];
                }
                if (p.use_ports)
                    for (int q = 0; q < PV; ++q)
                        if (s_gports[q]) f &= !p.ports[q * N + j];
                for (int a = 0; a < tcount; ++a) {
                    const int t = s_tidx[a];
                    const int dmv = p.dm[t * N + j];
                    if (s_symraa[a]) f &= p.downer[t * N + j] <= 0;
                    if (s_ra[a]) f &= dmv > 0 || s_firstok[a];
                    if (s_raa[a]) f &= dmv <= 0;
                }
                if (p.use_vols) {
                    int count_new[MAX_KINDS] = {0, 0, 0, 0};
                    int has_kind[MAX_KINDS] = {0, 0, 0, 0};
                    for (int s = 0; s < W; ++s) {
                        const int packed = s_vol[s];
                        if (!(packed & 1)) continue;
                        const int vid = packed >> 6, kind = (packed >> 3) & 7, ro = (packed >> 2) & 1;
                        const int row = p.volf[(long long)vid * N + j];
                        const int any = row & 1, ns = (row >> 1) & 1;
                        if (ro ? ns : any) f = false;
                        if (kind < K) {
                            count_new[kind] += 1 - any;
                            has_kind[kind] = 1;
                        }
                    }
                    for (int kk = 0; kk < K; ++kk)
                        if (has_kind[kk] && p.nk[kk * N + j] + count_new[kk] > p.vol_limits[kk]) f = false;
                }
            }
            feas[c] = f;
            if (j < N && p.wt[6]) {
                long long raw = p.interpod_raw[gid * N + j];
                for (int a = 0; a < tcount; ++a) {
                    const int t = s_tidx[a];
                    raw += (long long)s_ownw[a] * p.dm[t * N + j]
                         + (long long)s_symw[a] * p.downer[t * N + j];
                }
                ip[c] = raw;
            }
            if (f) {
                red[0] += 1;
                const int z = p.zone[j];
                const long long cnt = p.spread[gid * N + j];
                if (z >= 0) {
                    red[9] += 1;
#pragma unroll
                    for (int zz = 0; zz < MAX_ZONES; ++zz)
                        if (zz == z) red[1 + zz] += cnt;
                }
                red[10] = cnt > red[10] ? cnt : red[10];
                const long long aff = p.aff_raw[gid * N + j];
                red[11] = aff > red[11] ? aff : red[11];
                const long long tr = p.taint_raw[gid * N + j];
                red[12] = tr > red[12] ? tr : red[12];
                red[13] = ip[c] > red[13] ? ip[c] : red[13];
                red[14] = ip[c] < red[14] ? ip[c] : red[14];
            }
        }
        reduce_all(cluster, red, s_red, s_part, s_out, p.num_zones);
        const long long n_feas = s_out[0];
        const long long max_n = s_out[10];
        const long long aff_max = s_out[11];
        const long long taint_max = s_out[12];
        const long long ip_max = s_out[13] > 0 ? s_out[13] : 0;
        const long long ip_min = s_out[14] < 0 ? s_out[14] : 0;
        long long max_z = 0;
        for (int zz = 0; zz < p.num_zones; ++zz) max_z = s_out[1 + zz] > max_z ? s_out[1 + zz] : max_z;
        const bool have_zones = p.g_has_spread[gid] && s_out[9] > 0;

        // ---- 3. totals, best score, tie pick ----
        long long tot[CPT];
        long long best = I64_MIN;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int j = (c * cs + rank) * BLOCK + tid;
            tot[c] = I64_MIN;
            if (!feas[c]) continue;
            long long total = p.score_raw[gid * N + j];
            const long long cpu_req = (long long)p.nz[j] + s_gnz[0];
            const long long mem_req = (long long)p.nz[N + j] + s_gnz[1];
            const long long cpu_cap = p.alloc[j], mem_cap = p.alloc[N + j];
            if (p.wt[0])
                total += p.wt[0] * floordiv(usage(cpu_req, cpu_cap, false) + usage(mem_req, mem_cap, false), 2);
            if (p.wt[1])
                total += p.wt[1] * floordiv(usage(cpu_req, cpu_cap, true) + usage(mem_req, mem_cap, true), 2);
            if (p.wt[2]) {
                const long long f_cpu = floordiv(cpu_req * FP_ONE, cpu_cap > 1 ? cpu_cap : 1);
                const long long f_mem = floordiv(mem_req * FP_ONE, mem_cap > 1 ? mem_cap : 1);
                const long long diff = f_cpu > f_mem ? f_cpu - f_mem : f_mem - f_cpu;
                const bool bad = cpu_cap == 0 || mem_cap == 0 || cpu_req >= cpu_cap || mem_req >= mem_cap;
                total += p.wt[2] * (bad ? 0 : floordiv(FP - diff * MAX_PRIORITY, FP_ONE));
            }
            if (p.wt[3]) {
                const long long cnt = p.spread[gid * N + j];
                const long long node_fp = max_n > 0 ? floordiv((max_n - cnt) * FP, max_n) : FP;
                const int z = p.zone[j];
                long long total_fp = node_fp;
                if (have_zones && z >= 0) {
                    const long long zcnt = s_out[1 + z];
                    const long long zone_fp = max_z > 0 ? floordiv((max_z - zcnt) * FP, max_z) : FP;
                    total_fp = floordiv(node_fp + 2 * zone_fp, 3);
                }
                total += p.wt[3] * floordiv(total_fp, FP_ONE);
            }
            if (p.wt[4]) {
                const long long raw = p.aff_raw[gid * N + j];
                total += p.wt[4] * (aff_max > 0 ? floordiv(MAX_PRIORITY * raw, aff_max) : 0);
            }
            if (p.wt[5]) {
                const long long raw = p.taint_raw[gid * N + j];
                total += p.wt[5] * (taint_max > 0 ? floordiv(MAX_PRIORITY * (taint_max - raw), taint_max)
                                                  : MAX_PRIORITY);
            }
            if (p.wt[6]) {
                const long long rng = ip_max - ip_min;
                total += p.wt[6] * (rng > 0 ? floordiv(MAX_PRIORITY * (ip[c] - ip_min), rng) : 0);
            }
            tot[c] = total;
            best = total > best ? total : best;
        }
        // the cluster's best score
#pragma unroll
        for (int off = 16; off; off >>= 1) {
            const long long y = __shfl_xor_sync(FULL, best, off);
            best = y > best ? y : best;
        }
        if (lane == 0) s_wmax[warp] = best;
        __syncthreads();
        if (warp == 0) {
            long long x = s_wmax[lane];
#pragma unroll
            for (int off = 16; off; off >>= 1) {
                const long long y = __shfl_xor_sync(FULL, x, off);
                x = y > x ? y : x;
            }
            if (lane == 0) s_bmax = x;
        }
        cluster.sync();
        if (warp == 0) {
            long long x = lane < cs ? *cluster.map_shared_rank(&s_bmax, lane) : I64_MIN;
#pragma unroll
            for (int off = 16; off; off >>= 1) {
                const long long y = __shfl_xor_sync(FULL, x, off);
                x = y > x ? y : x;
            }
            if (lane == 0) s_gmax = x;
        }
        __syncthreads();
        const long long max_score = s_gmax;

        // ties: one ballot per (round, warp), then per-round counts
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const unsigned b = __ballot_sync(FULL, feas[c] && tot[c] == max_score);
            if (lane == 0) s_bal[c * NWARPS + warp] = b;
        }
        __syncthreads();
        if (warp < CPT) {
            int x = __popc(s_bal[warp * NWARPS + lane]);
#pragma unroll
            for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
            if (lane == 0) s_rt[warp] = x;
        }
        cluster.sync();
        // thread e scans slot e = round * cs + rank: slot order is node order
        const int x = tid < CPT * cs ? *cluster.map_shared_rank(&s_rt[tid / cs], tid % cs) : 0;
        int t_count = 0;
        const int before = block_exclusive_scan(x, s_scan, &t_count);
        const long long idx = rr % (t_count > 0 ? t_count : 1);
        if (n_feas > 0 && idx >= before && idx < before + x) {
            s_pick[0] = tid;
            s_pick[1] = static_cast<int>(idx - before);
        }
        __syncthreads();
        if (n_feas > 0 && warp == 0) {
            // lane w reads warp w's ballot of the picked (round, rank) slot
            const int c = s_pick[0] / cs, r = s_pick[0] % cs, k = s_pick[1];
            const unsigned m = *cluster.map_shared_rank(&s_bal[c * NWARPS + lane], r);
            const int n = __popc(m);
            int incl = n;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(FULL, incl, off);
                if (lane >= off) incl += y;
            }
            if (k >= incl - n && k < incl) {
                unsigned mm = m;
                for (int q = 0; q < k - (incl - n); ++q) mm &= mm - 1;
                s_chosen = (c * cs + r) * BLOCK + lane * 32 + (__ffs(mm) - 1);
            }
        }
        __syncthreads();
        const int ch = n_feas > 0 ? s_chosen : -1;
        if (n_feas >= 2) ++rr;
        if (rank == 0 && tid == 0) p.chosen[i] = ch;

        // ---- 4. commit: each block writes only the columns it owns ----
        if (ch >= 0) {
            const bool owner = (ch / BLOCK) % cs == rank;
            if (owner && ch % BLOCK == tid) {
                for (int r = 0; r < R; ++r) p.req[r * N + ch] += s_greq[r];
                p.nz[ch] += s_gnz[0];
                p.nz[N + ch] += s_gnz[1];
                p.cnt[ch] += 1;
                if (p.use_vols) {
                    for (int s = 0; s < W; ++s) {
                        const int packed = s_vol[s];
                        if (!(packed & 1)) continue;
                        const int vid = packed >> 6, kind = (packed >> 3) & 7;
                        const int ro = (packed >> 2) & 1, co = (packed >> 1) & 1;
                        uint8_t* cell = p.volf + (long long)vid * N + ch;
                        const int was_any = *cell & 1;
                        // count-only slots read the always-empty sentinel
                        // row and never write occupancy
                        if (!co) *cell = (uint8_t)(*cell | 1 | (ro ? 0 : 2));
                        if (kind < K && !was_any) p.nk[kind * N + ch] += 1;
                    }
                }
            }
            if (owner) {
                if (p.use_ports)
                    for (int q = tid; q < PV; q += BLOCK)
                        if (s_gports[q]) p.ports[q * N + ch] = 1;
                for (int h = tid; h < G; h += BLOCK) {
                    const int inc = p.spread_inc_t[gid * G + h];
                    if (inc) p.spread[h * N + ch] += inc;
                }
            }
            for (int a = 0; a < tcount; ++a) {
                const int m = s_mg[a], own = s_all[a];
                if (!m && !own) continue;
                const int t = s_tidx[a];
                if (!p.dom_valid[t * N + ch]) continue;
                const int d = p.node_domain[t * N + ch];
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    const int j = (c * cs + rank) * BLOCK + tid;
                    if (j < N && p.dom_valid[t * N + j] && p.node_domain[t * N + j] == d) {
                        p.dm[t * N + j] += m;
                        p.downer[t * N + j] += own;
                    }
                }
                if (tid == 0) s_total[t] += m;
            }
        }
        __syncthreads();
    }
    if (rank == 0 && tid == 0) p.rr_out[0] = (int32_t)rr;
    cluster.sync();  // no block leaves while another may read its shared memory
}

template <int CPT>
int launch(const ScanParams& params, int cs, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, 1, 1);
    cfg.blockDim = dim3(BLOCK, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, fused_scan_kernel<CPT>, params);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int fused_scan_launch(const ScanParams* params, void* stream) {
    if (params->r > MAX_R || params->t > MAX_TERMS || params->pv > MAX_PORTS ||
        params->w > MAX_SLOTS || params->k > MAX_KINDS || params->num_zones > MAX_ZONES)
        return -1;
    const int blocks = (params->n + BLOCK - 1) / BLOCK;
    const int cs = blocks < 1 ? 1 : (blocks < MAX_CLUSTER ? blocks : MAX_CLUSTER);
    const int cpt = (params->n + cs * BLOCK - 1) / (cs * BLOCK);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cpt <= 1) return launch<1>(*params, cs, s);
    if (cpt <= 2) return launch<2>(*params, cs, s);
    if (cpt <= 4) return launch<4>(*params, cs, s);
    if (cpt <= 8) return launch<8>(*params, cs, s);
    if (cpt <= MAX_CPT) return launch<MAX_CPT>(*params, cs, s);
    return -2;
}
