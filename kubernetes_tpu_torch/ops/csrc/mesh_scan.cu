// The sharded segment scan for Hopper (sm_90a): the sequential-greedy
// filter -> score -> selectHost -> commit loop over one segment's pods with
// the node axis split into S equal shards, each shard's columns served by B
// blocks of one cooperative launch.
//
// Replaces the JAX package's sharded wave loop
// (kubernetes_tpu/ops/batch_kernel.py::_sharded_loop_runner: the XLA step
// of make_step(axis_name=...) under shard_map, whose whole-axis reduces go
// through the _ax_* collective seams, psum / pmax / pmin and
// _ax_first_true's min over global indices). Its plain version is
// kubernetes_tpu_torch/ops/scan_ref.py::scan_shards (the step over each
// shard's columns, folded at exactly those seams). Both compute every score
// in int64 with floor division, lane for lane, as fused_scan.cu does.
//
// What it computes, for each pod of [start, start + count) in order:
//   every block filters and scores its columns; (a) the pod's statistics
//   (feasible count, feasible-and-zoned count, the spread, node-affinity
//   and taint maxima, the interpod extrema, the zone sums) are summed /
//   maxed / minned over every block of every shard; every block then
//   totals its columns' scores; (b) the best score and the ties at it are
//   gathered from every block, and every block derives the same chosen
//   node: the (rr % ties)-th tie in GLOBAL column order (shard-major, then
//   the shard's column), as _ax_first_true and the cross-shard tie prefix
//   do; only the block that owns the node commits its columns, every block
//   moves the affinity-domain counters of its own columns.
//
// Design (the simple one that is right; a cluster-based redesign with the
// planes in shared memory is later work):
//  - One cooperative launch (cudaLaunchCooperativeKernel) of S x B blocks:
//    blocks [s*B, (s+1)*B) serve shard s, block b its columns [b*cols,
//    (b+1)*cols). A grid that cannot be resident at once is refused by the
//    launch (the host raises); nothing falls back to the fused scan.
//  - Each shard's planes are its own tensors (parallel/mesh.py
//    place_static / place_state) in the fused scan's packed layout [rows,
//    ns]; a block reaches them through the per-shard pointer table. They
//    stay in global memory; a column is read and written only by its block,
//    so no state crosses blocks.
//  - Two exchanges a pod, through mailboxes in device memory, each followed
//    by a grid barrier (one atomic counter and a generation word): (a) a
//    block writes its 7 + Z statistics, (b) its best score, its tie count at
//    it and its tie bits (one 32-bit word a 32 columns, in column order).
//    Mailboxes are double-buffered by pod parity. Every block folds every
//    slot itself (the statistics are integer sums, maxima and minima, exact
//    in any order; the zone sums shard by shard, each shard's blocks first,
//    then the shards in rank order); the tie prefix runs over the blocks in
//    global column order, and the owner's tie bits name the node.
//  - The frontier loop (ops/frontier.py) launches it a chunk at a time with
//    the fused scan's control words: the counter in and out (ctl[CTL_RR]),
//    the stop flag (every block returns before touching anything once a
//    refresh has raised it), the chunk cursor. The state planes are updated
//    in place in global memory, so the refresh reads them with no write-back.
//
// What bounds it on this card: latency. A pod's chain is the filter of a
// block's columns, a block reduction, a grid barrier, the fold, the totals,
// a second block reduction, a second grid barrier and the tie pick; the
// barriers and the mailbox round trips to L2 dominate: 19.9 us a pod on the
// main segment in 4 shards (20 blocks) on an H100 80GB HBM3 at 700 W, 3x the
// fused scan, whose exchanges stay inside one thread-block cluster (PERF.md
// section 6, row 7).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_TERMS = 128;
constexpr int MAX_SLOTS = 8;
constexpr int MAX_KINDS = 4;
constexpr int MAX_R = 8;
constexpr int MAX_SHARDS = 16;
constexpr int TERM_FIELDS = 9;  // t, m_g, own_ra, own_raa, own_all, own_w, sym_w*m_g, m_g&&is_raa, self_match
constexpr int NSTAT = 7;        // nf, nzc, spread max, affinity max, taint max, interpod max, min
constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_PRIORITY = 10;
constexpr long long FP_ONE = 1024;
constexpr long long FP = MAX_PRIORITY * FP_ONE;
constexpr long long I64_MIN = (long long)(-9223372036854775807LL - 1);
constexpr long long I64_MAX = 9223372036854775807LL;

// A shard's planes in its row of the pointer table (mesh_scan.py
// SHARD_PLANES, same order), each [rows, ns] in the fused scan's layout.
enum ShardPlane {
    S_ALLOC = 0, S_ALLOC_PODS, S_EXISTS, S_ZONE, S_STATIC_OK, S_AFF, S_TAINT, S_SCORE,
    S_INTERPOD, S_NODE_DOMAIN, S_DOM_VALID, S_REQ, S_NZ, S_CNT, S_PORTS, S_SPREAD, S_DM,
    S_DOWNER, S_VOLF, S_NK, NSHARD_PLANES
};

}  // namespace

extern "C" {

struct MeshParams {
    const int64_t* shards;        // [S][NSHARD_PLANES] plane pointers
    // replicated tables
    const int32_t* sig;           // [G, sw]: request, nonzero, has_spread, term count, terms, ports
    const int32_t* spread_inc_t;  // [G, g4]
    const int32_t* vol_limits;    // [K]
    const int32_t* gids;          // [P] (at the chunk's first pod)
    const int32_t* pod_vol;       // [P, w4]: vid*64 | kind*8 | ro*4 | count_only*2 | valid
    int32_t* total;               // [T] total_match, read at entry, written back by block 0
    int32_t* chosen;              // [P] global column, -1 = unschedulable
    // exchanges, by pod parity
    int64_t* mbox_a;              // [2][S*B][msg_a]
    int64_t* mbox_b;              // [2][S*B][2]: best, ties
    uint32_t* ballots;            // [2][S*B][bw]
    uint32_t* barrier;            // [2]: arrivals, generation (zero at first use)
    // the frontier loop's control words
    int32_t* rr;                  // the counter, in and out
    const int32_t* stop;
    int32_t* cursor;
    int32_t shards_n, blocks, threads, cols, n_local, ns;
    int32_t g, g4, t, pv, v, r, w, w4, k, sw;
    int32_t p_real, num_zones, use_terms, use_vols, use_ports;
    int32_t msg_a, bw, smem_bytes;
    int32_t wt[7];  // least, most, balanced, spread, node_affinity, taint, interpod
};

}  // extern "C"

namespace {

// The fused scan's exact integer arithmetic (fused_scan.cu), repeated here
// so that its source, build and timings stay as they are.
__device__ __forceinline__ long long floordiv(long long a, long long b) {
    long long q = a / b;
    long long r = a - q * b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __noinline__ long long floordiv_far(long long a, long long b) { return floordiv(a, b); }

// floor(a / b) for b >= 1 with rb = 1.0 / b: exact for |a| < 2^50 (the
// double product is within 1/4 of a / b, the remainder corrects it)
__device__ __forceinline__ long long fdiv(long long a, long long b, double rb) {
    if (a > -(1LL << 50) && a < (1LL << 50)) {
        long long q = static_cast<long long>(floor(static_cast<double>(a) * rb));
        const long long r = a - q * b;
        if (r < 0) q -= 1;
        else if (r >= b) q += 1;
        return q;
    }
    return floordiv_far(a, b);
}

__device__ __forceinline__ long long usage(long long req, long long cap, bool most, double rcap) {
    const long long safe = cap > 1 ? cap : 1;
    const long long raw = most ? fdiv(req * MAX_PRIORITY, safe, rcap)
                               : fdiv((cap - req) * MAX_PRIORITY, safe, rcap);
    return (cap == 0 || req > cap) ? 0 : raw;
}

// least-requested | most-requested << 4 | balanced << 8, each in [0, 10]
__device__ __noinline__ int res_score(long long cpu_nz, long long mem_nz, long long cpu_cap,
                                      long long mem_cap) {
    const double rcpu = __drcp_rn(static_cast<double>(cpu_cap > 1 ? cpu_cap : 1));
    const double rmem = __drcp_rn(static_cast<double>(mem_cap > 1 ? mem_cap : 1));
    const long long least = floordiv(usage(cpu_nz, cpu_cap, false, rcpu) + usage(mem_nz, mem_cap, false, rmem), 2);
    const long long most = floordiv(usage(cpu_nz, cpu_cap, true, rcpu) + usage(mem_nz, mem_cap, true, rmem), 2);
    const long long f_cpu = fdiv(cpu_nz * FP_ONE, cpu_cap > 1 ? cpu_cap : 1, rcpu);
    const long long f_mem = fdiv(mem_nz * FP_ONE, mem_cap > 1 ? mem_cap : 1, rmem);
    const long long diff = f_cpu > f_mem ? f_cpu - f_mem : f_mem - f_cpu;
    const bool bad = cpu_cap == 0 || mem_cap == 0 || cpu_nz >= cpu_cap || mem_nz >= mem_cap;
    const long long balanced = bad ? 0 : floordiv(FP - diff * MAX_PRIORITY, FP_ONE);
    return static_cast<int>(least | (most << 4) | (balanced << 8));
}

// The position of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
    int pos = 0;
#pragma unroll
    for (int w = 16; w; w >>= 1) {
        const unsigned lo = m & ((1u << w) - 1u);
        const int c = __popc(lo);
        if (k >= c) {
            k -= c;
            m >>= w;
            pos += w;
        } else {
            m = lo;
        }
    }
    return pos;
}

__device__ __forceinline__ int warp_incl_scan(int x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
    }
    return x;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
    for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    return x;
}

__device__ __forceinline__ long long warp_max(long long x) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const long long y = __shfl_xor_sync(FULL, x, off);
        x = y > x ? y : x;
    }
    return x;
}

__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const long long y = __shfl_xor_sync(FULL, x, off);
        x = y < x ? y : x;
    }
    return x;
}

// statistic q's fold: sums (counts), maxima, the interpod minimum
__device__ __forceinline__ long long stat_fold(int q, long long a, long long b) {
    if (q < 2) return a + b;
    if (q < 6) return a > b ? a : b;
    return a < b ? a : b;
}

__device__ __forceinline__ long long stat_identity(int q) {
    return q < 2 ? 0 : q < 5 ? 0 : q == 5 ? I64_MIN : I64_MAX;
}

// A wait that never completes is a fault of the kernel: trap after about
// ten seconds, so the launch fails and the host raises, instead of hanging.
constexpr long long WAIT_LIMIT_CYCLES = 20000000000LL;

__device__ __forceinline__ unsigned ld_acquire(const uint32_t* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Every block of the grid arrives, then all go on: one arrival counter and
// a generation word, read by thread 0 of each block. The launch is
// cooperative, so every block is resident and the wait ends.
__device__ __forceinline__ void grid_sync(uint32_t* bar, unsigned nblocks, unsigned& gen) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned g = gen;
        __threadfence();
        if (atomicAdd(&bar[0], 1u) == nblocks - 1) {
            atomicExch(&bar[0], 0u);
            __threadfence();
            atomicExch(&bar[1], g + 1);
        } else {
            const long long start = clock64();
            while (ld_acquire(&bar[1]) == g)
                if (clock64() - start > WAIT_LIMIT_CYCLES) __trap();
        }
        __threadfence();
    }
    ++gen;
    __syncthreads();
}

__global__ void __launch_bounds__(MAX_THREADS) mesh_scan_kernel(const MeshParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ long long s_red[MAX_WARPS][NSTAT];  // each warp's statistics, then its best
    __shared__ long long s_stat[NSTAT + 1];        // the folded statistics, then the zone maximum
    __shared__ long long s_best;                   // this block's best score
    __shared__ int s_ties;                         // its ties at it
    __shared__ int s_ch;                           // the chosen global column
    __shared__ int s_total[MAX_TERMS];             // this block's copy of total_match
    __shared__ int s_vlim[MAX_KINDS];
    __shared__ const void* s_pl[NSHARD_PLANES];    // this block's shard's planes

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int BT = blockDim.x, NW = BT >> 5;
    const int B = p.blocks, SB = p.shards_n * B;
    const int bid = blockIdx.x, shard = bid / B, blk = bid - shard * B;
    const int L = p.cols, col0 = blk * L, NL = p.n_local, NS = p.ns;
    const int ncol = NL - col0 < L ? (NL - col0 > 0 ? NL - col0 : 0) : L;  // this block's columns
    const int R = p.r, T = p.t, G = p.g, PV = p.pv, W = p.w, K = p.k, SW = p.sw, G4 = p.g4;
    const int W4 = p.w4, NZ = p.num_zones, MA = p.msg_a, BW = p.bw;
    const int PORT0 = R + 4 + TERM_FIELDS * T;
    const bool wt_ip = p.wt[6] != 0;

    // dynamic shared memory: totals [L], interpod raw [L], the block's zone
    // sums [NZ], the folded zone totals [NZ], feasibility [L]
    long long* s_tot = reinterpret_cast<long long*>(smem);
    long long* s_ip = s_tot + L;
    long long* s_zacc = s_ip + L;
    long long* s_ztot = s_zacc + NZ;
    uint8_t* s_feas = reinterpret_cast<uint8_t*>(s_ztot + NZ);

    // a compaction is wanted (frontier loop): every block reads the same
    // flag, written by an earlier launch, so all return together
    if (*p.stop != 0) return;

    if (tid < NSHARD_PLANES)
        s_pl[tid] = reinterpret_cast<const void*>(p.shards[shard * NSHARD_PLANES + tid]);
    for (int t = tid; t < T; t += BT) s_total[t] = p.total[t];
    if (tid < K) s_vlim[tid] = p.vol_limits[tid];
    // every block reads the barrier's generation and the counter before its
    // first arrival, so all read the same values
    unsigned gen = tid == 0 ? ld_acquire(&p.barrier[1]) : 0u;
    uint32_t rr = static_cast<uint32_t>(*p.rr);
    __syncthreads();

    const int32_t* alloc = static_cast<const int32_t*>(s_pl[S_ALLOC]);
    const int32_t* alloc_pods = static_cast<const int32_t*>(s_pl[S_ALLOC_PODS]);
    const int32_t* exists = static_cast<const int32_t*>(s_pl[S_EXISTS]);
    const int32_t* zone = static_cast<const int32_t*>(s_pl[S_ZONE]);
    const int32_t* static_ok = static_cast<const int32_t*>(s_pl[S_STATIC_OK]);
    const int32_t* aff_raw = static_cast<const int32_t*>(s_pl[S_AFF]);
    const int32_t* taint_raw = static_cast<const int32_t*>(s_pl[S_TAINT]);
    const int32_t* score_raw = static_cast<const int32_t*>(s_pl[S_SCORE]);
    const int32_t* interpod_raw = static_cast<const int32_t*>(s_pl[S_INTERPOD]);
    const int32_t* node_domain = static_cast<const int32_t*>(s_pl[S_NODE_DOMAIN]);
    const int32_t* dom_valid = static_cast<const int32_t*>(s_pl[S_DOM_VALID]);
    int32_t* req = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_REQ]));
    int32_t* nz = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_NZ]));
    int32_t* cnt = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_CNT]));
    int32_t* ports = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_PORTS]));
    int32_t* spread = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_SPREAD]));
    int32_t* dm = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_DM]));
    int32_t* downer = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_DOWNER]));
    uint8_t* volf = const_cast<uint8_t*>(static_cast<const uint8_t*>(s_pl[S_VOLF]));
    int32_t* nk = const_cast<int32_t*>(static_cast<const int32_t*>(s_pl[S_NK]));

    for (int i = 0; i < p.p_real; ++i) {
        const int par = i & 1;
        const int gid = p.gids[i];
        const int32_t* sg = p.sig + (size_t)gid * SW;
        const int32_t* terms = sg + R + 4;
        const int32_t* gports = sg + PORT0;
        const int32_t* pvol = p.pod_vol + (size_t)i * W4;
        const int tcount = p.use_terms ? sg[R + 3] : 0;
        const size_t grow = (size_t)gid * NS;
        for (int z = tid; z < NZ; z += BT) s_zacc[z] = 0;
        __syncthreads();

        // ---- filter and raw score inputs of the block's columns ----
        long long st[NSTAT];
#pragma unroll
        for (int q = 0; q < NSTAT; ++q) st[q] = stat_identity(q);
        for (int c = tid; c < ncol; c += BT) {
            const int lc = col0 + c;
            const int z = zone[lc];
            const long long sc = spread[grow + lc];
            long long ipc = wt_ip ? interpod_raw[grow + lc] : 0;
            bool f = exists[lc] && static_ok[grow + lc] && cnt[lc] + 1 <= alloc_pods[lc];
            for (int r = 0; r < R; ++r) {
                const int gr = sg[r];
                if (gr > 0) f &= (long long)req[(size_t)r * NS + lc] + gr <= alloc[(size_t)r * NS + lc];
            }
            if (p.use_ports)
                for (int q = 0; q < PV; ++q)
                    if (gports[q]) f &= !ports[(size_t)q * NS + lc];
            for (int a = 0; a < tcount; ++a) {
                const int32_t* te = terms + a * TERM_FIELDS;
                const int t = te[0];
                const int dmv = dm[(size_t)t * NS + lc], dw = downer[(size_t)t * NS + lc];
                if (te[7]) f &= dw <= 0;
                if (te[2]) f &= dmv > 0 || (te[8] && s_total[t] == 0);
                if (te[3]) f &= dmv <= 0;
                if (wt_ip) ipc += (long long)te[5] * dmv + (long long)te[6] * dw;
            }
            if (p.use_vols) {
                int count_new[MAX_KINDS] = {0, 0, 0, 0};
                int has_kind[MAX_KINDS] = {0, 0, 0, 0};
                for (int s = 0; s < W; ++s) {
                    const int packed = pvol[s];
                    if (!(packed & 1)) continue;
                    const int vid = packed >> 6, kind = (packed >> 3) & 7, ro = (packed >> 2) & 1;
                    const int cell = volf[(size_t)vid * NS + lc];
                    const int any = cell & 1, nsh = (cell >> 1) & 1;
                    if (ro ? nsh : any) f = false;
#pragma unroll
                    for (int kk = 0; kk < MAX_KINDS; ++kk)
                        if (kk == kind && kk < K) {
                            count_new[kk] += 1 - any;
                            has_kind[kk] = 1;
                        }
                }
#pragma unroll
                for (int kk = 0; kk < MAX_KINDS; ++kk)
                    if (kk < K && has_kind[kk] && nk[(size_t)kk * NS + lc] + count_new[kk] > s_vlim[kk])
                        f = false;
            }
            if (f) {
                st[0] += 1;
                if (z >= 0) {
                    st[1] += 1;
                    if (z < NZ)
                        atomicAdd(reinterpret_cast<unsigned long long*>(&s_zacc[z]),
                                  static_cast<unsigned long long>(sc));
                }
                st[2] = sc > st[2] ? sc : st[2];
                const long long aff = aff_raw[grow + lc], tr = taint_raw[grow + lc];
                st[3] = aff > st[3] ? aff : st[3];
                st[4] = tr > st[4] ? tr : st[4];
                st[5] = ipc > st[5] ? ipc : st[5];
                st[6] = ipc < st[6] ? ipc : st[6];
            }
            s_feas[c] = f;
            s_ip[c] = ipc;
        }

        // ---- exchange (a): the block's statistics, folded by every block ----
        st[0] = warp_sum(st[0]);
        st[1] = warp_sum(st[1]);
        st[2] = warp_max(st[2]);
        st[3] = warp_max(st[3]);
        st[4] = warp_max(st[4]);
        st[5] = warp_max(st[5]);
        st[6] = warp_min(st[6]);
        if (lane == 0) {
#pragma unroll
            for (int q = 0; q < NSTAT; ++q) s_red[warp][q] = st[q];
        }
        __syncthreads();
        int64_t* ma = p.mbox_a + ((size_t)par * SB + bid) * MA;
        if (tid < NSTAT) {
            long long v = stat_identity(tid);
            for (int w = 0; w < NW; ++w) v = stat_fold(tid, v, s_red[w][tid]);
            ma[tid] = v;
        }
        for (int z = tid; z < NZ; z += BT) ma[NSTAT + z] = s_zacc[z];
        grid_sync(p.barrier, SB, gen);

        const int64_t* mas = p.mbox_a + (size_t)par * SB * MA;
        if (warp == 0) {
            long long v[NSTAT];
#pragma unroll
            for (int q = 0; q < NSTAT; ++q) v[q] = stat_identity(q);
            for (int slot = lane; slot < SB; slot += 32) {
#pragma unroll
                for (int q = 0; q < NSTAT; ++q)
                    v[q] = stat_fold(q, v[q], __ldcg(reinterpret_cast<const long long*>(mas + (size_t)slot * MA + q)));
            }
            v[0] = warp_sum(v[0]);
            v[1] = warp_sum(v[1]);
            v[2] = warp_max(v[2]);
            v[3] = warp_max(v[3]);
            v[4] = warp_max(v[4]);
            v[5] = warp_max(v[5]);
            v[6] = warp_min(v[6]);
            if (lane == 0) {
#pragma unroll
                for (int q = 0; q < NSTAT; ++q) s_stat[q] = v[q];
            }
        }
        // the zone totals: each shard's blocks, then the shards in rank order
        for (int z = tid; z < NZ; z += BT) {
            long long sum = 0;
            for (int s = 0; s < p.shards_n; ++s) {
                long long part = 0;
                for (int b = 0; b < B; ++b)
                    part += __ldcg(reinterpret_cast<const long long*>(mas + (size_t)(s * B + b) * MA + NSTAT + z));
                sum += part;
            }
            s_ztot[z] = sum;
        }
        __syncthreads();
        if (warp == 0) {
            long long mz = 0;
            for (int z = lane; z < NZ; z += 32) mz = s_ztot[z] > mz ? s_ztot[z] : mz;
            mz = warp_max(mz);
            if (lane == 0) s_stat[NSTAT] = mz;
        }
        __syncthreads();
        const long long n_feas = s_stat[0];
        const bool have_zones = sg[R + 2] && s_stat[1] > 0;
        const long long max_n = s_stat[2], aff_max = s_stat[3], taint_max = s_stat[4];
        const long long ip_max = s_stat[5] > 0 ? s_stat[5] : 0, ip_min = s_stat[6] < 0 ? s_stat[6] : 0;
        const long long max_z = s_stat[NSTAT], rng = ip_max - ip_min;

        // ---- totals, and the block's best score ----
        long long best = I64_MIN;
        if (n_feas > 0) {
            const double r_maxn = __drcp_rn(static_cast<double>(max_n > 1 ? max_n : 1));
            const double r_maxz = __drcp_rn(static_cast<double>(max_z > 1 ? max_z : 1));
            const double r_aff = __drcp_rn(static_cast<double>(aff_max > 1 ? aff_max : 1));
            const double r_taint = __drcp_rn(static_cast<double>(taint_max > 1 ? taint_max : 1));
            const double r_rng = __drcp_rn(static_cast<double>(rng > 1 ? rng : 1));
            for (int c = tid; c < ncol; c += BT) {
                if (!s_feas[c]) continue;
                const int lc = col0 + c;
                const int rs = res_score((long long)nz[lc] + sg[R], (long long)nz[NS + lc] + sg[R + 1],
                                         alloc[lc], alloc[NS + lc]);
                long long total = (long long)score_raw[grow + lc] + (long long)p.wt[0] * (rs & 15) +
                                  (long long)p.wt[1] * ((rs >> 4) & 15) + (long long)p.wt[2] * (rs >> 8);
                if (p.wt[3]) {
                    const long long sc = spread[grow + lc];
                    const long long node_fp = max_n > 0 ? fdiv((max_n - sc) * FP, max_n, r_maxn) : FP;
                    const int z = zone[lc];
                    long long total_fp = node_fp;
                    if (have_zones && z >= 0) {
                        const long long zcnt = z < NZ ? s_ztot[z] : 0;
                        const long long zone_fp = max_z > 0 ? fdiv((max_z - zcnt) * FP, max_z, r_maxz) : FP;
                        total_fp = floordiv(node_fp + 2 * zone_fp, 3);
                    }
                    total += p.wt[3] * floordiv(total_fp, FP_ONE);
                }
                if (p.wt[4]) {
                    const long long raw = aff_raw[grow + lc];
                    total += p.wt[4] * (aff_max > 0 ? fdiv(MAX_PRIORITY * raw, aff_max, r_aff) : 0);
                }
                if (p.wt[5]) {
                    const long long raw = taint_raw[grow + lc];
                    total += p.wt[5] * (taint_max > 0 ? fdiv(MAX_PRIORITY * (taint_max - raw), taint_max, r_taint)
                                                      : MAX_PRIORITY);
                }
                if (wt_ip)
                    total += p.wt[6] * (rng > 0 ? fdiv(MAX_PRIORITY * (s_ip[c] - ip_min), rng, r_rng) : 0);
                s_tot[c] = total;
                best = total > best ? total : best;
            }
        }
        best = warp_max(best);
        if (lane == 0) s_red[warp][0] = best;
        __syncthreads();
        if (tid == 0) {
            long long bb = I64_MIN;
            for (int w = 0; w < NW; ++w) bb = s_red[w][0] > bb ? s_red[w][0] : bb;
            s_best = bb;
            s_ties = 0;
        }
        __syncthreads();

        // ---- exchange (b): the best, the ties at it, the tie bits ----
        const long long bb = s_best;
        uint32_t* bal = p.ballots + ((size_t)par * SB + bid) * BW;
        for (int base = 0; base < L; base += BT) {
            const int c = base + tid;
            const bool tie = bb != I64_MIN && c < ncol && s_feas[c] && s_tot[c] == bb;
            const unsigned m = __ballot_sync(FULL, tie);
            if (lane == 0 && base + warp * 32 < L) {
                bal[(base >> 5) + warp] = m;
                if (m) atomicAdd(&s_ties, __popc(m));
            }
        }
        __syncthreads();
        if (tid == 0) {
            int64_t* mb = p.mbox_b + ((size_t)par * SB + bid) * 2;
            mb[0] = bb;
            mb[1] = s_ties;
        }
        grid_sync(p.barrier, SB, gen);

        // every block picks the same node: the (rr % ties)-th tie in global
        // column order (block q = shard * B + block covers the columns from
        // shard * n_local + block * cols)
        if (warp == 0) {
            int ch = -1;
            if (n_feas > 0) {
                const long long* mbs = reinterpret_cast<const long long*>(p.mbox_b + (size_t)par * SB * 2);
                long long top = I64_MIN;
                for (int q = lane; q < SB; q += 32) {
                    const long long b = __ldcg(mbs + 2 * q);
                    top = b > top ? b : top;
                }
                top = warp_max(top);
                long long all = 0;
                for (int q = lane; q < SB; q += 32)
                    if (__ldcg(mbs + 2 * q) == top) all += __ldcg(mbs + 2 * q + 1);
                all = warp_sum(all);
                const int idx = static_cast<int>(rr % static_cast<uint32_t>(all));
                int run = 0, owner = -1, k = 0;
                for (int q0 = 0; q0 < SB && owner < 0; q0 += 32) {
                    const int q = q0 + lane;
                    int tq = 0;
                    if (q < SB && __ldcg(mbs + 2 * q) == top) tq = static_cast<int>(__ldcg(mbs + 2 * q + 1));
                    const int incl = warp_incl_scan(tq) + run;
                    const unsigned hit = __ballot_sync(FULL, tq > 0 && idx >= incl - tq && idx < incl);
                    if (hit) {
                        const int src = __ffs(hit) - 1;
                        owner = q0 + src;
                        k = idx - __shfl_sync(FULL, incl - tq, src);
                    }
                    run = __shfl_sync(FULL, incl, 31);
                }
                // the k-th set bit of the owner's tie bits, 32 words at a time
                const uint32_t* ob = p.ballots + ((size_t)par * SB + owner) * BW;
                int node = -1;
                for (int e0 = 0; e0 < BW && node < 0; e0 += 32) {
                    const int e = e0 + lane;
                    const unsigned word = e < BW ? __ldcg(ob + e) : 0u;
                    const int n = __popc(word);
                    const int in_ = warp_incl_scan(n);
                    const unsigned got = __ballot_sync(FULL, k >= in_ - n && k < in_);
                    if (got) {
                        const int src = __ffs(got) - 1;
                        int pos = 0;
                        if (lane == src) pos = e * 32 + nth_set_bit(word, k - (in_ - n));
                        node = __shfl_sync(FULL, pos, src);
                    } else {
                        k -= __shfl_sync(FULL, in_, 31);
                    }
                }
                const int os = owner / B;
                ch = os * NL + (owner - os * B) * L + node;
            }
            if (lane == 0) s_ch = ch;
        }
        __syncthreads();
        const int ch = s_ch;
        if (n_feas >= 2) ++rr;
        if (bid == 0 && tid == 0) p.chosen[i] = ch;

        // ---- commit: the owner block its column, every block its domains ----
        if (ch >= 0) {
            const int os = ch / NL, lcc = ch - os * NL;
            if (os == shard && lcc >= col0 && lcc < col0 + L) {
                if (tid == 0) {
                    for (int r = 0; r < R; ++r) req[(size_t)r * NS + lcc] += sg[r];
                    nz[lcc] += sg[R];
                    nz[NS + lcc] += sg[R + 1];
                    cnt[lcc] += 1;
                    if (p.use_vols) {
                        for (int s = 0; s < W; ++s) {
                            const int packed = pvol[s];
                            if (!(packed & 1)) continue;
                            const int vid = packed >> 6, kind = (packed >> 3) & 7;
                            const int ro = (packed >> 2) & 1, co = (packed >> 1) & 1;
                            uint8_t& cell = volf[(size_t)vid * NS + lcc];
                            const int was_any = cell & 1;
                            // count-only slots read the always-empty sentinel
                            // row and never write occupancy
                            if (!co) cell = static_cast<uint8_t>(cell | 1 | (ro ? 0 : 2));
                            if (kind < K && !was_any) nk[(size_t)kind * NS + lcc] += 1;
                        }
                    }
                }
                if (p.use_ports)
                    for (int q = tid; q < PV; q += BT)
                        if (gports[q]) ports[(size_t)q * NS + lcc] = 1;
                for (int h = tid; h < G; h += BT) {
                    const int v = p.spread_inc_t[(size_t)gid * G4 + h];
                    if (v) spread[(size_t)h * NS + lcc] += v;
                }
            }
            const int64_t* own = p.shards + (size_t)os * NSHARD_PLANES;
            const int32_t* o_domain = reinterpret_cast<const int32_t*>(own[S_NODE_DOMAIN]);
            const int32_t* o_valid = reinterpret_cast<const int32_t*>(own[S_DOM_VALID]);
            for (int a = 0; a < tcount; ++a) {
                const int32_t* te = terms + a * TERM_FIELDS;
                const int m = te[1], ow = te[4];
                if (!m && !ow) continue;
                const int t = te[0];
                // the chosen node's domain, from its shard's rows
                const int valid = o_valid[(size_t)t * NS + lcc], d = o_domain[(size_t)t * NS + lcc];
                if (valid)
                    for (int c = tid; c < ncol; c += BT) {
                        const size_t e = (size_t)t * NS + col0 + c;
                        if (dom_valid[e] && node_domain[e] == d) {
                            dm[e] += m;
                            downer[e] += ow;
                        }
                    }
                if (tid == 0) s_total[t] += m;
            }
        }
        __syncthreads();
    }
    if (bid == 0) {
        for (int t = tid; t < T; t += BT) p.total[t] = s_total[t];
        if (tid == 0) {
            *p.rr = static_cast<int32_t>(rr);
            *p.cursor += 1;
        }
    }
}

// 0 when the parameters fit the kernel, else -1
int check(const MeshParams& p) {
    const long long sb = (long long)p.shards_n * p.blocks;
    if (p.shards_n < 1 || p.shards_n > MAX_SHARDS || p.blocks < 1 || p.threads < 32 ||
        p.threads > MAX_THREADS || p.threads % 32 || p.cols < 32 || p.cols % 32 ||
        (long long)p.blocks * p.cols < p.n_local || p.ns < p.n_local || p.bw != p.cols / 32 ||
        p.r < 2 || p.r > MAX_R || p.t < 0 || p.t > MAX_TERMS || p.w > MAX_SLOTS || p.k > MAX_KINDS ||
        p.num_zones < 0 || p.msg_a != NSTAT + p.num_zones || p.sw < p.r + 4 + TERM_FIELDS * p.t + p.pv ||
        p.g4 < p.g || p.w4 < p.w || p.p_real < 0 || sb > 65535 ||
        p.smem_bytes < 17 * p.cols + 16 * p.num_zones)
        return -1;
    return 0;
}

// The most blocks of this launch's shape that can be resident at once.
int resident_blocks(const MeshParams& p, int* out) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && p.smem_bytes > 48 * 1024)
        err = cudaFuncSetAttribute(mesh_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   p.smem_bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mesh_scan_kernel, p.threads,
                                                            p.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return -5;  // the device cannot launch a cooperative grid
    *out = per_sm * sms;
    return 0;
}

}  // namespace

// 0 on a launch; -1 parameters the kernel does not take, -4 a grid that
// cannot be resident at once, -5 no cooperative launch on the device; else
// the launch's CUDA error
extern "C" int mesh_scan_launch(const MeshParams* params, void* stream) {
    if (check(*params) != 0) return -1;
    int most = 0;
    const int err = resident_blocks(*params, &most);
    if (err != 0) return err;
    if (most < params->shards_n * params->blocks) return -4;
    void* args[] = {const_cast<MeshParams*>(params)};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)mesh_scan_kernel, dim3(params->shards_n * params->blocks),
        dim3(params->threads), args, params->smem_bytes, static_cast<cudaStream_t>(stream));
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// How many blocks of this shape the card holds at once (no launch).
extern "C" int mesh_scan_query(const MeshParams* params, int* max_blocks) {
    if (check(*params) != 0) return -1;
    return resident_blocks(*params, max_blocks);
}
