// Fused segment scan for Hopper (sm_90a): the whole sequential-greedy
// filter -> score -> selectHost -> commit loop over one segment's pods in a
// single persistent thread-block cluster.
//
// Replaces the JAX package's fused Pallas kernel
// (kubernetes_tpu/ops/pallas_kernel.py::_pallas_runner -> kernel). The plain
// version it is held against is kubernetes_tpu_torch/ops/scan_ref.py; both
// compute every score in int64 with floor division, lane for lane.
//
// What bounds it. Pods run one after another, so a pod's time is a chain:
// read its signature, test and score every column, reduce the statistics
// over the cluster, reduce the best score and its ties, commit. The work
// per pod is small (~100 integer operations a column); the chain's latency
// is the cost. The previous design (1024-thread blocks, at most 8, state
// planes in global memory) spent 15 us a pod: 4.2 us in the statistics
// reduction and its cluster barrier, 4.4 us in the totals and the
// best-score barrier, 2.9 us in the filter's L2 round trips, 2.1 us in the
// tie pick, 1.1 us in the per-pod prologue (clock64 split on the main
// segment on an H100 80GB HBM3 at 700 W, PERF.md section 5). This design
// takes 6.6 us a pod there; what
// bounds it now is the chain of dependent instructions inside each block
// (a single block runs about 10 us a pod even at 128 nodes), not the
// cluster: the two exchanges' waits are 1.6 us of it.
//
// Design, each choice against one of those costs:
//  1. State in shared memory. Cluster rank r owns the contiguous columns
//     [r*cols, (r+1)*cols). At launch it bulk-copies (cp.async.bulk on an
//     mbarrier, one copy a row) its slice of every plane that the host's
//     planner (fused_scan.plan) placed in shared memory; after that it reads
//     and updates them there. A column is touched only by its owner, so no
//     state crosses SMs. Planes that did not fit stay in global memory and
//     are read through the same code: each plane is a base pointer and a
//     row stride (cols in shared memory, ns in global memory). The shared
//     copies are not written back: nothing reads the state planes after a
//     launch, only `chosen` and `rr_out`.
//  2. The next pods' inputs in flight. Every gid is known at launch. While
//     pod i computes, one thread bulk-copies pod i+2's signature row
//     (requests, term list and flags, ports), its volume slots, its spread
//     increments and the block's slice of its five static score rows into
//     the third of three buffers, completed on that buffer's mbarrier.
//     These inputs never change during the scan, so the prefetch is exact;
//     spread[gid] is mutable and is read from its plane.
//  3. Two cluster exchanges a pod, each one message from every block to
//     every block. (a) Statistics: each warp reduces its columns' feasible
//     count, zone sums and score extrema on the redux.sync unit and leaves
//     them in shared memory; the block's last warp to finish (an atomic
//     count) folds them and sends the block's message with st.async into
//     slot [rank] of every block's inbox, whose mbarrier the bytes complete.
//     (b) Best and ties: the same way, the block's best score, its tie
//     count and its warps' tie ballots at that best. A block waits on its
//     own mbarrier, not on a cluster barrier, so it goes on as soon as the
//     last message lands; every warp folds the inbox itself (lane q reads
//     block q's message), so no block-wide barrier follows. From (b) every
//     warp takes the global best, the ties of the blocks at it and their
//     prefix over ranks, which name the block and rank of the
//     (rr % ties)-th tie; node order within a block is (column round,
//     warp, lane), so every block decodes the same node from its inbox.
//     Inboxes and their mbarriers are double-buffered by pod parity. Why no
//     block writes slot i % 2 while another still reads it: a block reads
//     pod i's inboxes before the barrier that ends its pod i, and sends its
//     pod i+1 messages after it. A sender's pod i+2 message needs that
//     sender to have received every block's pod i+1 (a) message first, so
//     it lands after the reader has finished pod i. The reader re-arms the
//     mbarrier for pod i+2 (expect_tx) once pod i's phase completed; bytes
//     that come before the re-arm are counted in the new phase.
//  4. Smaller blocks, more SMs: up to 16 blocks (a non-portable cluster) of
//     `threads` threads, each thread owning `CPT` columns c*threads + tid, so
//     a warp reads 32 consecutive words of a row (no bank conflicts). Where
//     every plane fits in shared memory (SH), a separate instantiation lets
//     the compiler use shared-memory loads.
//  5. Zones. Up to REG_ZONES zones, each thread keeps its columns' zone
//     sums in registers and the warps fold them on the redux.sync unit (the
//     main path). A segment with more zones (a zone key that spans regions)
//     runs the BZ instantiation, with the zone statistics where the planner
//     (fused_scan.py) placed them. In shared memory: threads add their
//     columns' spread counts into a per-zone accumulator (64-bit shared
//     atomics), the last warp sends it in exchange (a), whose message is 10
//     + 2 words a zone, and the block folds the blocks' messages into
//     per-zone totals. Past what shared memory holds (zbuf set): each block
//     adds into its own row of a global scratch, by pod parity, fences, and
//     sends only the 10 words; after exchange (a) every block folds the
//     cluster's rows from L2 into its own totals row (a second fold), and a
//     block clears its row for pod i+2 once exchange (b) of pod i+1 shows
//     that every block has folded pod i. No zone count is refused: the
//     planner owns the layout, and dispatch checks only that msg_a and the
//     zone arrays fit what it was given.
//  7. Host ports. A signature row carries the segment's port flags, and its
//     first MAX_PORTS flags travel with the row into shared memory (the
//     planner's `sws`). A pod whose signature has more ports than that
//     reads the rest of its flags from the row in global memory.
//  6. Less arithmetic a pod. The resource scores (least-requested,
//     most-requested, balanced) of a column change only when a pod lands on
//     it, so they are kept per (signature, column) in the `res` plane and a
//     column's are recomputed at its commit. The other floor divisions take
//     a double-precision reciprocal and one exact integer correction (fdiv
//     below) instead of the 64-bit integer division routine.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_CPT = 16;
constexpr int REG_ZONES = 8;  // zones whose sums a thread keeps in registers
constexpr int MAX_TERMS = 128;
constexpr int MAX_PORTS = 256;  // port flags a signature row holds in shared memory
constexpr int MAX_SLOTS = 8;
constexpr int MAX_KINDS = 4;
constexpr int MAX_R = 8;
constexpr int TERM_FIELDS = 9;  // t, m_g, own_ra, own_raa, own_all, own_w, sym_w*m_g, m_g&&is_raa, self_match
constexpr int POD_ROWS = 5;     // static_ok, aff_raw, taint_raw, score_raw, interpod_raw
constexpr int NBUF = 3;         // pod input buffers: pod i+2 is fetched while pod i runs
constexpr int MAX_MSG_A = 28;   // words of a register-path statistics message: 10 + 2 a zone, padded to 4
constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_PRIORITY = 10;
constexpr long long FP_ONE = 1024;
constexpr long long FP = MAX_PRIORITY * FP_ONE;
constexpr long long I64_MIN = (long long)(-9223372036854775807LL - 1);
constexpr long long I64_MAX = 9223372036854775807LL;

// Placement slots of ScanParams::off, in the planner's order
// (fused_scan.PLANES): the byte offset of the plane in dynamic shared
// memory, or -1 where it stays in global memory.
enum Plane {
    P_POD = 0, P_INC, P_REQ, P_NZ, P_CNT, P_PORTS, P_DM, P_DOWNER, P_VOLF, P_NK,
    P_SPREAD, P_RES, P_ALLOC, P_ALLOC_PODS, P_EXISTS, P_ZONE, P_NODE_DOMAIN, P_DOM_VALID,
    NPLANES
};

}  // namespace

extern "C" {

struct ScanParams {
    // static node-axis planes, row-major [rows, ns], zero past column n
    const int32_t* alloc;         // [R, ns]
    const int32_t* alloc_pods;    // [ns]
    const int32_t* exists;        // [ns]
    const int32_t* zone;          // [ns], -1 = no zone
    const int32_t* static_ok;     // [G, ns]
    const int32_t* aff_raw;       // [G, ns]
    const int32_t* taint_raw;     // [G, ns]
    const int32_t* score_raw;     // [G, ns]
    const int32_t* interpod_raw;  // [G, ns]
    const int32_t* node_domain;   // [T, ns]
    const int32_t* dom_valid;     // [T, ns]
    // per-signature tables
    const int32_t* sig;           // [G, sw]: request, nonzero, has_spread, term count, terms, ports
    const int32_t* spread_inc_t;  // [G, g4]: row g = increments of every signature when g lands
    const int32_t* vol_limits;    // [K]
    // per pod
    const int32_t* gids;          // [P]
    const int32_t* pod_vol;       // [P, w4]: vid*64 | kind*8 | ro*4 | count_only*2 | valid
    // mutable state (working copies, updated in place where in global memory)
    int32_t* req;                 // [R, ns]
    int32_t* nz;                  // [2, ns]
    int32_t* cnt;                 // [ns]
    int32_t* ports;               // [Pv, ns]
    int32_t* spread;              // [G, ns]
    int32_t* dm;                  // [T, ns]
    int32_t* downer;              // [T, ns]
    int32_t* total;               // [T]
    uint8_t* volf;                // [V, ns]: bit 0 any instance, bit 1 non-sharable
    int32_t* nk;                  // [K, ns]
    uint16_t* res;                // [G, ns] scratch: resource scores, see res_score
    // outputs
    int32_t* chosen;              // [P]
    int32_t* rr_out;              // [1]
    // past shared memory's zone budget: [2][cs][num_zones] accumulators by
    // pod parity, then [cs][num_zones] totals, zeroed by the host; else null
    int64_t* zbuf;
    // sizes, the plan and flags
    int32_t n, ns, cols, cs, threads, cpt;
    int32_t g, g4, t, pv, v, r, w, w4, k, sw, sws;  // sws: ints of a signature row in shared memory
    int32_t p_real, num_zones, rr0;
    int32_t use_terms, use_vols, use_ports, smem_bytes;
    int32_t gnz_off, inbox_a_off, inbox_b_off, msg_a, msg_b;  // the planner's fixed layout
    int32_t zone_off;  // past REG_ZONES: the zone accumulator and totals, 2 x num_zones int64
    int32_t wt[7];    // least, most, balanced, spread, node_affinity, taint, interpod
    int32_t off[18];  // NPLANES placement offsets
};

}  // extern "C"

namespace {

static_assert(sizeof(((ScanParams*)0)->off) / sizeof(int32_t) == NPLANES, "off[] has one slot a plane");

__device__ __forceinline__ long long floordiv(long long a, long long b) {
    long long q = a / b;
    long long r = a - q * b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// kept out of line: the rare path of fdiv, and the loop's code stays small
__device__ __noinline__ long long floordiv_far(long long a, long long b) { return floordiv(a, b); }

// floor(a / b) for b >= 1, with rb = 1.0 / b. Exact: for |a| < 2^50 the
// double product a * rb is within 2^50 * 2^-51.9 < 1/4 of a / b (two
// roundings of at most 2^-53 relative each), so floor() of it is off by at
// most one and the integer remainder corrects it; larger |a| take the
// integer division.
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

// The resource scores of one signature on one node, each in [0, 10]:
// least-requested | most-requested << 4 | balanced << 8. They change only
// when a pod lands on the node, so the kernel keeps them per (signature,
// column) in the `res` plane and recomputes a column's at its commit.
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

// Warp reductions of 64-bit values on the redux.sync unit (32-bit
// operands): a sum as four 16-bit digit sums (each below 2^21, added back
// modulo 2^64: exact wherever the true sum fits in int64), a maximum or
// minimum as the high words' extremum, then the low words' among the lanes
// that hold it.
__device__ __forceinline__ long long warp_sum64(long long x) {
    const unsigned long long u = static_cast<unsigned long long>(x);
    unsigned long long s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        s += static_cast<unsigned long long>(
                 __reduce_add_sync(FULL, static_cast<unsigned>((u >> (16 * k)) & 0xffffu))) << (16 * k);
    return static_cast<long long>(s);
}

__device__ __forceinline__ long long join64(int hi, unsigned lo) {
    return static_cast<long long>((static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) | lo);
}

__device__ __forceinline__ long long warp_max64(long long x) {
    const int hi = static_cast<int>(x >> 32);
    const int mh = __reduce_max_sync(FULL, hi);
    const unsigned ml = __reduce_max_sync(FULL, hi == mh ? static_cast<unsigned>(x) : 0u);
    return join64(mh, ml);
}

__device__ __forceinline__ long long warp_min64(long long x) {
    const int hi = static_cast<int>(x >> 32);
    const int mh = __reduce_min_sync(FULL, hi);
    const unsigned ml = __reduce_min_sync(FULL, hi == mh ? static_cast<unsigned>(x) : 0xffffffffu);
    return join64(mh, ml);
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

// Called by every warp of the block: true in the last warp to get here
// (counted in *done), which then sees every other warp's earlier writes.
__device__ __forceinline__ bool last_warp(int* done, int nwarps) {
    __threadfence_block();
    int n = 0;
    if ((threadIdx.x & 31) == 0) n = atomicAdd(done, 1);
    n = __shfl_sync(FULL, n, 0);
    __threadfence_block();
    return n == nwarps - 1;
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

// ---- Hopper primitives: mbarriers, bulk copies, split cluster barriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// A wait that never completes is a fault of the kernel: trap after about
// ten seconds, so the launch fails and the host raises, instead of hanging.
constexpr long long WAIT_LIMIT_CYCLES = 20000000000LL;

__device__ __forceinline__ void wait_guard(long long start) {
    if (clock64() - start > WAIT_LIMIT_CYCLES) __trap();
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    const long long start = clock64();
    for (;; wait_guard(start)) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (done) return;
    }
}

// global -> this block's shared memory; bytes and both addresses are
// multiples of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Four words into block `rank`'s shared memory at the address `local`
// has in this block, completing `bytes` (16) on that block's copy of `bar`.
__device__ __forceinline__ void send4(const void* local, const uint64_t* bar, int rank, uint32_t w0,
                                      uint32_t w1, uint32_t w2, uint32_t w3) {
    uint32_t ra, rb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(smem_addr(local)), "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
        :: "r"(ra), "r"(w0), "r"(w1), "r"(w2), "r"(w3), "r"(rb) : "memory");
}

// wait for a phase of a barrier that the cluster's blocks complete
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    const long long start = clock64();
    for (;; wait_guard(start)) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (done) return;
    }
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rows of each placed plane at this segment's shapes (0 = the kernel never
// reads it), its element size, and its global base
__device__ __forceinline__ int plane_rows(const ScanParams& p, int k) {
    const int terms = p.use_terms ? p.t : 0, vols = p.use_vols;
    switch (k) {
        case P_REQ: case P_ALLOC: return p.r;
        case P_NZ: return 2;
        case P_CNT: case P_ALLOC_PODS: case P_EXISTS: case P_ZONE: return 1;
        case P_PORTS: return p.use_ports ? p.pv : 0;
        case P_DM: case P_DOWNER: case P_NODE_DOMAIN: case P_DOM_VALID: return terms;
        case P_VOLF: return vols ? p.v : 0;
        case P_NK: return vols ? p.k : 0;
        case P_SPREAD: case P_RES: return p.g;
        default: return 0;
    }
}

__device__ __forceinline__ const void* plane_global(const ScanParams& p, int k) {
    switch (k) {
        case P_REQ: return p.req;
        case P_NZ: return p.nz;
        case P_CNT: return p.cnt;
        case P_PORTS: return p.ports;
        case P_DM: return p.dm;
        case P_DOWNER: return p.downer;
        case P_VOLF: return p.volf;
        case P_NK: return p.nk;
        case P_SPREAD: return p.spread;
        case P_RES: return p.res;
        case P_ALLOC: return p.alloc;
        case P_ALLOC_PODS: return p.alloc_pods;
        case P_EXISTS: return p.exists;
        case P_ZONE: return p.zone;
        case P_NODE_DOMAIN: return p.node_domain;
        case P_DOM_VALID: return p.dom_valid;
        default: return nullptr;
    }
}

// A plane as this block sees it: its first column, and its row stride.
template <typename T>
struct View {
    T* at;
    int stride;
    __device__ __forceinline__ T& operator()(int row, int col) const { return at[row * stride + col]; }
};

// With SH (every plane placed in shared memory, known at compile time) the
// compiler sees shared-memory pointers and emits shared loads.
template <bool SH, typename T>
__device__ __forceinline__ View<T> view(T* global, int off, unsigned char* smem, int base, int cols, int ns) {
    if (SH || off >= 0) return View<T>{reinterpret_cast<T*>(smem + off), cols};
    return View<T>{global + base, ns};
}

}  // namespace

namespace {

// Phase clock: built with -DFUSED_SCAN_PHASES, thread 0 of rank 0 sums
// clock64() deltas per phase over the pods (scripts/fused_scan_phases.py
// reads them); compiled out otherwise.
#ifdef FUSED_SCAN_PHASES
constexpr int NPHASES = 10;
__device__ unsigned long long g_phases[NPHASES];
#define PHASE(k) do { if (clocked) { const long long t_ = clock64(); phase_acc[k] += t_ - phase_t; phase_t = t_; } } while (0)
#else
#define PHASE(k) do { } while (0)
#endif

template <int CPT, bool SH, bool BZ>
__global__ void __launch_bounds__(MAX_THREADS, 1) fused_scan_kernel(const ScanParams p) {
    cg::cluster_group cluster = cg::this_cluster();
#ifdef FUSED_SCAN_PHASES
    const bool clocked = cluster.block_rank() == 0 && threadIdx.x == 0;
    long long phase_acc[NPHASES] = {};
    long long phase_t = clock64();
#endif
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ uint64_t s_bar[1 + NBUF];  // state load; one per pod buffer
    __shared__ uint64_t s_xa[2];          // exchange (a) inbox complete, by pod parity
    __shared__ uint64_t s_xb[2];          // exchange (b) inbox complete, by pod parity
    // each warp's part of this block's messages, by pod parity; the last
    // warp of the block to write its part (counted in s_done) sends them
    __shared__ uint32_t s_part[2][MAX_MSG_A][MAX_WARPS];  // exchange (a), word-major
    __shared__ long long s_wb[2][MAX_WARPS];              // exchange (b): each warp's best
    __shared__ int s_wt[2][MAX_WARPS];                    // its ties at that best
    __shared__ uint32_t s_bal[2][MAX_CPT * MAX_WARPS];    // its tie ballots, (column round, warp)
    __shared__ int s_done[4];                             // (a) and (b), by pod parity
    __shared__ int s_total[MAX_TERMS];    // this block's copy of total_match
    __shared__ int s_vlim[MAX_KINDS];
    __shared__ int s_gid[NBUF];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int BT = blockDim.x, NW = BT >> 5;
    const int CS = p.cs, L = p.cols, NS = p.ns;
    const int rank = static_cast<int>(cluster.block_rank());
    const int base = rank * L;
    const int R = p.r, T = p.t, G = p.g, PV = p.pv, W = p.w, K = p.k;
    const int SW = p.sw, SWS = p.sws, G4 = p.g4, W4 = p.w4, MA = p.msg_a, MB = p.msg_b;
    const int NZ = p.num_zones;
    // zone statistics in global memory (zg), as 64-bit words
    long long* const zbuf = reinterpret_cast<long long*>(p.zbuf);
    const bool zg = BZ && zbuf != nullptr;
    // a signature's port flags in its shared row, and where the rest start
    // in its global row
    const int PORT0 = R + 4 + TERM_FIELDS * T;
    const int PQ = PV < SWS - PORT0 ? PV : SWS - PORT0;
    const bool wt_ip = p.wt[6] != 0;
    const int ENTS = CPT * NW;  // tie ballots a block sends
    const uint32_t bytes_a = CS * MA * 4, bytes_b = CS * MB * 4;

    // dynamic shared memory: [sig NBUF x sws][pod_vol NBUF x w4] at 0, the
    // nonzero requests of every signature [g4 x 2], the two inboxes, then
    // the placed planes (offsets from the planner)
    int32_t* s_sig = reinterpret_cast<int32_t*>(smem);
    int32_t* s_pvol = s_sig + NBUF * SWS;
    const int32_t* s_gnz = reinterpret_cast<const int32_t*>(smem + p.gnz_off);
    // inboxes [2][chunk][CS] of 16-byte chunks: lane q reads block q's
    // chunk k without bank conflicts
    uint4* s_ina = reinterpret_cast<uint4*>(smem + p.inbox_a_off);
    uint4* s_inb = reinterpret_cast<uint4*>(smem + p.inbox_b_off);
    const bool pod_rows_shared = SH || p.off[P_POD] >= 0;
    const bool inc_shared = SH || p.off[P_INC] >= 0;
    int32_t* s_pod = pod_rows_shared ? reinterpret_cast<int32_t*>(smem + p.off[P_POD]) : nullptr;
    int32_t* s_inc = inc_shared ? reinterpret_cast<int32_t*>(smem + p.off[P_INC]) : nullptr;
    const int32_t* g_rows[POD_ROWS] = {p.static_ok, p.aff_raw, p.taint_raw, p.score_raw, p.interpod_raw};
    // BZ in shared memory: this block's zone sums of the pod [NZ], then the
    // cluster's [NZ]; in global memory (zg): the cluster's, this block's row
    long long* s_zacc = BZ && !zg ? reinterpret_cast<long long*>(smem + p.zone_off) : nullptr;
    long long* s_ztot = BZ && !zg ? s_zacc + NZ : nullptr;
    long long* g_ztot = zg ? zbuf + ((size_t)2 * CS + rank) * NZ : nullptr;

    const View<int32_t> req = view<SH>(p.req, p.off[P_REQ], smem, base, L, NS);
    const View<int32_t> nz = view<SH>(p.nz, p.off[P_NZ], smem, base, L, NS);
    const View<int32_t> cnt = view<SH>(p.cnt, p.off[P_CNT], smem, base, L, NS);
    const View<int32_t> ports = view<SH>(p.ports, p.off[P_PORTS], smem, base, L, NS);
    const View<int32_t> dm = view<SH>(p.dm, p.off[P_DM], smem, base, L, NS);
    const View<int32_t> downer = view<SH>(p.downer, p.off[P_DOWNER], smem, base, L, NS);
    const View<uint8_t> volf = view<SH>(p.volf, p.off[P_VOLF], smem, base, L, NS);
    const View<int32_t> nk = view<SH>(p.nk, p.off[P_NK], smem, base, L, NS);
    const View<int32_t> spread = view<SH>(p.spread, p.off[P_SPREAD], smem, base, L, NS);
    const View<uint16_t> res = view<SH>(p.res, p.off[P_RES], smem, base, L, NS);
    const View<const int32_t> alloc = view<SH>(p.alloc, p.off[P_ALLOC], smem, base, L, NS);
    const View<const int32_t> alloc_pods = view<SH>(p.alloc_pods, p.off[P_ALLOC_PODS], smem, base, L, NS);
    const View<const int32_t> exists = view<SH>(p.exists, p.off[P_EXISTS], smem, base, L, NS);
    const View<const int32_t> zone = view<SH>(p.zone, p.off[P_ZONE], smem, base, L, NS);
    const View<const int32_t> node_domain = view<SH>(p.node_domain, p.off[P_NODE_DOMAIN], smem, base, L, NS);
    const View<const int32_t> dom_valid = view<SH>(p.dom_valid, p.off[P_DOM_VALID], smem, base, L, NS);

    if (tid == 0) {
        for (int b = 0; b < 1 + NBUF; ++b) mbar_init(&s_bar[b]);
        for (int b = 0; b < 2; ++b) {
            mbar_init(&s_xa[b]);
            mbar_init(&s_xb[b]);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        // the first two pods' inboxes (parities 0 and 1)
        for (int b = 0; b < 2; ++b) {
            mbar_expect_tx(&s_xa[b], bytes_a);
            mbar_expect_tx(&s_xb[b], bytes_b);
        }
    }
    for (int t = tid; t < T; t += BT) s_total[t] = p.total[t];
    if (tid < K) s_vlim[tid] = p.vol_limits[tid];
    if (tid < 4) s_done[tid] = 0;
    if (BZ && !zg)
        for (int z = tid; z < NZ; z += BT) s_zacc[z] = 0;
    for (int h = tid; h < G; h += BT) {
        int32_t* gnz = const_cast<int32_t*>(s_gnz);
        gnz[2 * h] = p.sig[(size_t)h * SW + R];
        gnz[2 * h + 1] = p.sig[(size_t)h * SW + R + 1];
    }
    __syncthreads();

    // ---- this block's slice of every placed plane, one bulk copy a row ----
    if (warp == 0) {
        uint32_t bytes = 0;
        for (int k = P_REQ; k < NPLANES; ++k)
            if (p.off[k] >= 0 && k != P_RES) bytes += plane_rows(p, k) * L * (k == P_VOLF ? 1 : 4);
        if (lane == 0) mbar_expect_tx(&s_bar[0], bytes);
        __syncwarp();
        for (int k = P_REQ; k < NPLANES; ++k) {
            if (p.off[k] < 0 || k == P_RES) continue;  // res is computed below
            const int esz = k == P_VOLF ? 1 : 4;
            const unsigned char* src = static_cast<const unsigned char*>(plane_global(p, k));
            for (int row = lane; row < plane_rows(p, k); row += 32)
                bulk_load(smem + p.off[k] + (size_t)row * L * esz,
                          src + ((size_t)row * NS + base) * esz, L * esz, &s_bar[0]);
        }
    }

    // pod i's inputs into buffer i % NBUF, issued by lane 0 of the last warp
    auto prefetch = [&](int i, int gid) {
        const int b = i % NBUF;
        uint32_t bytes = (SWS + W4) * 4;
        if (pod_rows_shared) bytes += POD_ROWS * L * 4;
        if (inc_shared) bytes += G4 * 4;
        s_gid[b] = gid;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&s_bar[1 + b], bytes);
        bulk_load(s_sig + b * SWS, p.sig + (size_t)gid * SW, SWS * 4, &s_bar[1 + b]);
        bulk_load(s_pvol + b * W4, p.pod_vol + (size_t)i * W4, W4 * 4, &s_bar[1 + b]);
        if (inc_shared) bulk_load(s_inc + b * G4, p.spread_inc_t + (size_t)gid * G4, G4 * 4, &s_bar[1 + b]);
        if (pod_rows_shared)
            for (int k = 0; k < POD_ROWS; ++k)
                bulk_load(s_pod + (b * POD_ROWS + k) * L, g_rows[k] + (size_t)gid * NS + base,
                          L * 4, &s_bar[1 + b]);
    };
    const bool issuer = tid == BT - 32;
    int gid_ahead = 0;  // the issuer's: gid of the next pod to prefetch
    if (issuer) {
        for (int i = 0; i < NBUF - 1 && i < p.p_real; ++i) prefetch(i, p.gids[i]);
        if (NBUF - 1 < p.p_real) gid_ahead = p.gids[NBUF - 1];
    }
    mbar_wait(&s_bar[0], 0);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        const int lc = c * BT + tid;
        if (lc >= L) continue;
        const int cn = nz(0, lc), mn = nz(1, lc), cc = alloc(0, lc), mc = alloc(1, lc);
        for (int h = 0; h < G; ++h)
            res(h, lc) = static_cast<uint16_t>(
                res_score((long long)cn + s_gnz[2 * h], (long long)mn + s_gnz[2 * h + 1], cc, mc));
    }
    // every block has initialised its barriers before any block sends
    cluster_arrive();
    cluster_wait();

    // the round-robin counter: one a pod at most, from the 32-bit rr0 into
    // the 32-bit rr_out, so 32 unsigned bits hold it
    uint32_t rr = static_cast<uint32_t>(p.rr0);
    // this block's column that took a pod at the last commit, or -1: its
    // resource scores are refreshed during the next pod's exchanges
    int stale = -1;
    for (int i = 0; i < p.p_real; ++i) {
        const int b = i % NBUF, par = i & 1;
        const uint32_t xpar = (i >> 1) & 1;
        mbar_wait(&s_bar[1 + b], (i / NBUF) & 1);
        const int gid = s_gid[b];
        const int32_t* sg = s_sig + b * SWS;
        const int32_t* terms = sg + R + 4;
        const int32_t* gports = sg + PORT0;
        const int32_t* gports_far = p.sig + (size_t)gid * SW + PORT0;  // flags PQ.. of a wide row
        // zg: this block's row of the pod's zone sums
        long long* g_zacc = zg ? zbuf + ((size_t)par * CS + rank) * NZ : nullptr;
        const int32_t* pvol = s_pvol + b * W4;
        const int tcount = p.use_terms ? sg[R + 3] : 0;
        const int32_t* row[POD_ROWS];
#pragma unroll
        for (int k = 0; k < POD_ROWS; ++k)
            row[k] = pod_rows_shared ? s_pod + (b * POD_ROWS + k) * L : g_rows[k] + (size_t)gid * NS + base;
        const int32_t* spread_row = &spread(gid, 0);
        PHASE(0);  // prologue: buffer wait, signature

        // ---- filter and raw score inputs, each column's reads issued first ----
        bool feas[CPT];
        long long ip[CPT];
        int nf = 0, nzc = 0, smax = 0, amax = 0, tmax = 0;
        long long zsum[REG_ZONES];
#pragma unroll
        for (int z = 0; z < REG_ZONES; ++z) zsum[z] = 0;
        long long ipmax = I64_MIN, ipmin = I64_MAX;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int lc = c * BT + tid;
            bool f = false;
            long long ipc = 0;
            if (lc < L) {
                const int ex = exists(0, lc), ok = row[0][lc], cn = cnt(0, lc), cap = alloc_pods(0, lc);
                const int z = zone(0, lc), sc = spread_row[lc], aff = row[1][lc], tr = row[2][lc];
                if (wt_ip) ipc = row[4][lc];
                f = ex && ok && cn + 1 <= cap;
                for (int r = 0; r < R; ++r) {
                    const int gr = sg[r];
                    if (gr > 0) f &= (long long)req(r, lc) + gr <= alloc(r, lc);
                }
                if (p.use_ports) {
                    for (int q = 0; q < PQ; ++q)
                        if (gports[q]) f &= !ports(q, lc);
                    for (int q = PQ; q < PV; ++q)
                        if (gports_far[q]) f &= !ports(q, lc);
                }
                for (int a = 0; a < tcount; ++a) {
                    const int32_t* te = terms + a * TERM_FIELDS;
                    const int t = te[0];
                    const int dmv = dm(t, lc), dw = downer(t, lc);
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
                        const int cell = volf(vid, lc);
                        const int any = cell & 1, ns = (cell >> 1) & 1;
                        if (ro ? ns : any) f = false;
#pragma unroll
                        for (int kk = 0; kk < MAX_KINDS; ++kk)
                            if (kk == kind && kk < K) {
                                count_new[kk] += 1 - any;
                                has_kind[kk] = 1;
                            }
                    }
#pragma unroll
                    for (int kk = 0; kk < MAX_KINDS; ++kk)
                        if (kk < K && has_kind[kk] && nk(kk, lc) + count_new[kk] > s_vlim[kk]) f = false;
                }
                if (f) {
                    nf += 1;
                    if (z >= 0) {
                        nzc += 1;
                        if constexpr (BZ) {
                            if (z < NZ) {
                                const unsigned long long v = static_cast<unsigned long long>(static_cast<long long>(sc));
                                if (zg) atomicAdd(reinterpret_cast<unsigned long long*>(&g_zacc[z]), v);
                                else atomicAdd(reinterpret_cast<unsigned long long*>(&s_zacc[z]), v);
                            }
                        } else {
#pragma unroll
                            for (int zz = 0; zz < REG_ZONES; ++zz)
                                if (zz == z) zsum[zz] += sc;
                        }
                    }
                    smax = sc > smax ? sc : smax;
                    amax = aff > amax ? aff : amax;
                    tmax = tr > tmax ? tr : tmax;
                    ipmax = ipc > ipmax ? ipc : ipmax;
                    ipmin = ipc < ipmin ? ipc : ipmin;
                }
            }
            feas[c] = f;
            ip[c] = ipc;
        }
        PHASE(1);  // filter and raw inputs

        // ---- exchange (a): the block's statistics to every block ----
        {
            nf = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(nf)));
            nzc = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(nzc)));
            smax = __reduce_max_sync(FULL, smax);
            amax = __reduce_max_sync(FULL, amax);
            tmax = __reduce_max_sync(FULL, tmax);
            if (wt_ip) {
                ipmax = warp_max64(ipmax);
                ipmin = warp_min64(ipmin);
            }
            if constexpr (!BZ) {
#pragma unroll
                for (int zz = 0; zz < REG_ZONES; ++zz)
                    if (zz < NZ) zsum[zz] = warp_sum64(zsum[zz]);
            } else {
                // the warp's zone atomics before its lane 0 counts it done;
                // in global memory, before any block can read them
                if (zg) __threadfence();
                __syncwarp();
            }
            if (lane == 0) {
                uint32_t(*pa)[MAX_WARPS] = s_part[par];
                pa[0][warp] = nf;
                pa[1][warp] = nzc;
                pa[2][warp] = smax;
                pa[3][warp] = amax;
                pa[4][warp] = tmax;
                pa[6][warp] = static_cast<uint32_t>(ipmax);
                pa[7][warp] = static_cast<uint32_t>(ipmax >> 32);
                pa[8][warp] = static_cast<uint32_t>(ipmin);
                pa[9][warp] = static_cast<uint32_t>(ipmin >> 32);
                if constexpr (!BZ) {
#pragma unroll
                    for (int zz = 0; zz < REG_ZONES; ++zz)
                        if (zz < NZ) {
                            pa[10 + 2 * zz][warp] = static_cast<uint32_t>(zsum[zz]);
                            pa[11 + 2 * zz][warp] = static_cast<uint32_t>(zsum[zz] >> 32);
                        }
                }
            }
            if (last_warp(&s_done[par], NW)) {
                // the block's message: folded over its warps' parts (lane w
                // reads warp w's), then sent to every block
                const bool has = lane < NW;
                uint32_t(*pa)[MAX_WARPS] = s_part[par];
                uint32_t m[MAX_MSG_A];
#pragma unroll
                for (int q = 0; q < MAX_MSG_A; ++q) m[q] = 0;
                m[0] = __reduce_add_sync(FULL, has ? pa[0][lane] : 0u);
                m[1] = __reduce_add_sync(FULL, has ? pa[1][lane] : 0u);
#pragma unroll
                for (int q = 2; q < 5; ++q)
                    m[q] = static_cast<uint32_t>(__reduce_max_sync(FULL, has ? static_cast<int>(pa[q][lane]) : 0));
                if (wt_ip) {
                    const long long hi = warp_max64(has ? join64(pa[7][lane], pa[6][lane]) : I64_MIN);
                    const long long lo = warp_min64(has ? join64(pa[9][lane], pa[8][lane]) : I64_MAX);
                    m[6] = static_cast<uint32_t>(hi);
                    m[7] = static_cast<uint32_t>(hi >> 32);
                    m[8] = static_cast<uint32_t>(lo);
                    m[9] = static_cast<uint32_t>(lo >> 32);
                }
                if constexpr (!BZ) {
#pragma unroll
                    for (int zz = 0; zz < REG_ZONES; ++zz)
                        if (zz < NZ) {
                            const long long v = warp_sum64(has ? join64(pa[11 + 2 * zz][lane], pa[10 + 2 * zz][lane]) : 0);
                            m[10 + 2 * zz] = static_cast<uint32_t>(v);
                            m[11 + 2 * zz] = static_cast<uint32_t>(v >> 32);
                        }
                }
                if (lane == 0) s_done[par] = 0;  // for pod i+2
                if constexpr (!BZ) {
                    if (lane < CS) {
#pragma unroll
                        for (int q = 0; q < MAX_MSG_A; q += 4)
                            if (q < MA)
                                send4(&s_ina[(par * (MA / 4) + q / 4) * CS + rank], &s_xa[par], lane,
                                      m[q], m[q + 1], m[q + 2], m[q + 3]);
                    }
                } else if (zg) {
                    // the zone sums went to this block's global row: only the
                    // statistics' 10 words travel
                    if (lane < CS) {
                        uint4* to = &s_ina[par * (MA / 4) * CS + rank];
                        send4(to, &s_xa[par], lane, m[0], m[1], m[2], m[3]);
                        send4(to + CS, &s_xa[par], lane, m[4], m[5], m[6], m[7]);
                        send4(to + 2 * CS, &s_xa[par], lane, m[8], m[9], 0u, 0u);
                    }
                } else {
                    // words 10 + 2z, 11 + 2z: zone z's sum from the accumulator;
                    // chunk k >= 3 holds zones 2k - 5 and 2k - 4
                    if (lane < CS) {
                        uint4* to = &s_ina[par * (MA / 4) * CS + rank];
                        const long long z0 = s_zacc[0];
                        send4(to, &s_xa[par], lane, m[0], m[1], m[2], m[3]);
                        send4(to + CS, &s_xa[par], lane, m[4], m[5], m[6], m[7]);
                        send4(to + 2 * CS, &s_xa[par], lane, m[8], m[9], static_cast<uint32_t>(z0),
                              static_cast<uint32_t>(z0 >> 32));
                        for (int k = 3; k < MA / 4; ++k) {
                            const int za = 2 * k - 5, zb = 2 * k - 4;
                            const long long va = za < NZ ? s_zacc[za] : 0, vb = zb < NZ ? s_zacc[zb] : 0;
                            send4(to + k * CS, &s_xa[par], lane, static_cast<uint32_t>(va),
                                  static_cast<uint32_t>(va >> 32), static_cast<uint32_t>(vb),
                                  static_cast<uint32_t>(vb >> 32));
                        }
                    }
                    __syncwarp();
                    for (int z = lane; z < NZ; z += 32) s_zacc[z] = 0;  // for pod i+1
                }
            }
        }
        // the stale column's score for this pod's signature, by the thread
        // that reads it in the totals below (the other signatures' follow
        // in exchange (b)'s wait)
        if (stale >= 0 && tid == stale % BT)
            res(gid, stale) = static_cast<uint16_t>(res_score((long long)nz(0, stale) + s_gnz[2 * gid],
                                                              (long long)nz(1, stale) + s_gnz[2 * gid + 1],
                                                              alloc(0, stale), alloc(1, stale)));
        PHASE(2);  // (a) statistics sent, stale score refreshed
        mbar_wait_cluster(&s_xa[par], xpar);
        if (tid == 0) mbar_expect_tx(&s_xa[par], bytes_a);  // for pod i+2
        PHASE(3);  // (a) wait
        // every warp folds the blocks' messages itself (lane q: block q's),
        // so no block-wide barrier follows
        const bool from = lane < CS;
        // BZ: words 0-11 here, the zone words are folded in shared memory below
        constexpr int XA = BZ ? 12 : MAX_MSG_A;
        uint32_t xa[XA];
#pragma unroll
        for (int q = 0; q < XA; q += 4) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (q < MA && from) v = s_ina[(par * (MA / 4) + q / 4) * CS + lane];
            xa[q] = v.x;
            xa[q + 1] = v.y;
            xa[q + 2] = v.z;
            xa[q + 3] = v.w;
        }
        const long long n_feas = __reduce_add_sync(FULL, xa[0]);
        const bool have_zones = sg[R + 2] && __reduce_add_sync(FULL, xa[1]) > 0;
        const long long max_n = __reduce_max_sync(FULL, static_cast<int>(xa[2]));
        const long long aff_max = __reduce_max_sync(FULL, static_cast<int>(xa[3]));
        const long long taint_max = __reduce_max_sync(FULL, static_cast<int>(xa[4]));
        long long ip_max = 0, ip_min = 0;
        if (wt_ip) {
            ip_max = warp_max64(from ? join64(xa[7], xa[6]) : I64_MIN);
            ip_min = warp_min64(from ? join64(xa[9], xa[8]) : I64_MAX);
            ip_max = ip_max > 0 ? ip_max : 0;
            ip_min = ip_min < 0 ? ip_min : 0;
        }
        long long max_z = 0;
        if constexpr (!BZ) {
#pragma unroll
            for (int zz = 0; zz < REG_ZONES; ++zz)
                if (zz < NZ) {
                    zsum[zz] = warp_sum64(join64(xa[11 + 2 * zz], xa[10 + 2 * zz]));
                    max_z = zsum[zz] > max_z ? zsum[zz] : max_z;
                }
        } else if (zg) {
            // the second fold: the cluster's rows from L2 (past L1, which
            // does not see other blocks' atomics), one zone a thread, into
            // this block's totals row
            const long long* rows = zbuf + (size_t)par * CS * NZ;
            for (int z = tid; z < NZ; z += BT) {
                long long sum = 0;
                for (int q = 0; q < CS; ++q) sum += __ldcg(rows + (size_t)q * NZ + z);
                g_ztot[z] = sum;
            }
            __syncthreads();
            long long mz = 0;
            for (int z = lane; z < NZ; z += 32) mz = g_ztot[z] > mz ? g_ztot[z] : mz;
            max_z = warp_max64(mz);
        } else {
            // the cluster's zone totals, one zone a thread, then every
            // warp's maximum over them
            const uint32_t* ina = reinterpret_cast<const uint32_t*>(s_ina);
            for (int z = tid; z < NZ; z += BT) {
                const int w = 10 + 2 * z;  // even: both halves in one chunk
                long long sum = 0;
                for (int q = 0; q < CS; ++q) {
                    const uint32_t* c = ina + ((par * (MA / 4) + (w >> 2)) * CS + q) * 4 + (w & 3);
                    sum += join64(static_cast<int>(c[1]), c[0]);
                }
                s_ztot[z] = sum;
            }
            __syncthreads();
            long long mz = 0;
            for (int z = lane; z < NZ; z += 32) mz = s_ztot[z] > mz ? s_ztot[z] : mz;
            max_z = warp_max64(mz);
        }
        const long long rng = ip_max - ip_min;
        PHASE(4);  // (a) fold

        // ---- totals, then each warp's best score and its ties ----
        long long best = I64_MIN;
        long long tot[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) tot[c] = 0;
        if (n_feas > 0) {
            const double r_maxn = __drcp_rn(static_cast<double>(max_n > 1 ? max_n : 1));
            const double r_maxz = __drcp_rn(static_cast<double>(max_z > 1 ? max_z : 1));
            const double r_aff = __drcp_rn(static_cast<double>(aff_max > 1 ? aff_max : 1));
            const double r_taint = __drcp_rn(static_cast<double>(taint_max > 1 ? taint_max : 1));
            const double r_rng = __drcp_rn(static_cast<double>(rng > 1 ? rng : 1));
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const int lc = c * BT + tid;
                if (!feas[c]) continue;
                const int rs = res(gid, lc);
                long long total = (long long)row[3][lc] + (long long)p.wt[0] * (rs & 15) +
                                  (long long)p.wt[1] * ((rs >> 4) & 15) + (long long)p.wt[2] * (rs >> 8);
                if (p.wt[3]) {
                    const long long sc = spread_row[lc];
                    const long long node_fp = max_n > 0 ? fdiv((max_n - sc) * FP, max_n, r_maxn) : FP;
                    const int z = zone(0, lc);
                    long long total_fp = node_fp;
                    if (have_zones && z >= 0) {
                        long long zcnt = 0;
                        if constexpr (BZ) {
                            if (z < NZ) zcnt = zg ? g_ztot[z] : s_ztot[z];
                        } else {
#pragma unroll
                            for (int zz = 0; zz < REG_ZONES; ++zz)
                                if (zz == z) zcnt = zsum[zz];
                        }
                        const long long zone_fp = max_z > 0 ? fdiv((max_z - zcnt) * FP, max_z, r_maxz) : FP;
                        total_fp = floordiv(node_fp + 2 * zone_fp, 3);
                    }
                    total += p.wt[3] * floordiv(total_fp, FP_ONE);
                }
                if (p.wt[4]) {
                    const long long raw = row[1][lc];
                    total += p.wt[4] * (aff_max > 0 ? fdiv(MAX_PRIORITY * raw, aff_max, r_aff) : 0);
                }
                if (p.wt[5]) {
                    const long long raw = row[2][lc];
                    total += p.wt[5] * (taint_max > 0 ? fdiv(MAX_PRIORITY * (taint_max - raw), taint_max, r_taint)
                                                      : MAX_PRIORITY);
                }
                if (wt_ip)
                    total += p.wt[6] * (rng > 0 ? fdiv(MAX_PRIORITY * (ip[c] - ip_min), rng, r_rng) : 0);
                tot[c] = total;
                best = total > best ? total : best;
            }
        }
        PHASE(5);  // totals

        // ---- exchange (b): the block's best score and its ties at it ----
        {
            const long long wbest = warp_max64(best);
            unsigned bl[CPT];
            int wties = 0;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                bl[c] = __ballot_sync(FULL, feas[c] && tot[c] == wbest);
                wties += __popc(bl[c]);
            }
            if (lane == 0) {
                s_wb[par][warp] = wbest;
                s_wt[par][warp] = wties;
#pragma unroll
                for (int c = 0; c < CPT; ++c) s_bal[par][c * NW + warp] = bl[c];
            }
            if (last_warp(&s_done[2 + par], NW)) {
                // message: the best, the ties at it, then the ballots in
                // (column round, warp) order, zero for warps below the best
                const long long wb = lane < NW ? s_wb[par][lane] : I64_MIN;
                const long long bb = warp_max64(wb);
                const bool at = lane < NW && bb != I64_MIN && wb == bb;
                const unsigned atb = __ballot_sync(FULL, at);
                const unsigned ties = __reduce_add_sync(FULL, at ? static_cast<unsigned>(s_wt[par][lane]) : 0u);
                if (lane == 0) s_done[2 + par] = 0;  // for pod i+2
                if (lane < CS) {
                    int q = 0, w = 0;  // next ballot, and its warp
                    for (int k = 0; k < MB / 4; ++k) {
                        uint32_t v[4];
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const int slot = 4 * k + j;
                            if (slot < 3) {
                                v[j] = slot == 0 ? static_cast<uint32_t>(bb)
                                     : slot == 1 ? static_cast<uint32_t>(bb >> 32) : ties;
                            } else if (q < ENTS) {
                                v[j] = (atb >> w) & 1 ? s_bal[par][q] : 0u;
                                ++q;
                                w = w + 1 == NW ? 0 : w + 1;
                            } else {
                                v[j] = 0;
                            }
                        }
                        send4(&s_inb[(par * (MB / 4) + k) * CS + rank], &s_xb[par], lane, v[0], v[1], v[2], v[3]);
                    }
                }
            }
        }
        // the pod after next into its buffer (it held pod i-1, which every
        // thread of this block finished)
        if (issuer && i + NBUF - 1 < p.p_real) {
            prefetch(i + NBUF - 1, gid_ahead);
            if (i + NBUF < p.p_real) gid_ahead = p.gids[i + NBUF];
        }
        if (stale >= 0) {
            const long long cn = nz(0, stale), mn = nz(1, stale), cc = alloc(0, stale), mc = alloc(1, stale);
            for (int h = tid; h < G; h += BT)
                if (h != gid) res(h, stale) = static_cast<uint16_t>(res_score(cn + s_gnz[2 * h], mn + s_gnz[2 * h + 1], cc, mc));
            stale = -1;
        }
        PHASE(6);  // (b) sent, prefetch issued, stale scores refreshed
        mbar_wait_cluster(&s_xb[par], xpar);
        if (tid == 0) mbar_expect_tx(&s_xb[par], bytes_b);  // for pod i+2
        if (zg) {
            // every block has folded pod i-1's rows (it sent pod i's (b)
            // message after): clear this block's row for pod i+1
            long long* next = zbuf + ((size_t)((i + 1) & 1) * CS + rank) * NZ;
            for (int z = tid; z < NZ; z += BT) next[z] = 0;
            __threadfence();
        }
        PHASE(7);  // (b) wait

        // every warp picks the same node: the (rr % ties)-th tie in node
        // order (block, column round, warp, lane); lane q reads block q's
        int ch = -1;
        if (n_feas > 0) {
            const uint4* in = s_inb + par * (MB / 4) * CS;  // [chunk][CS]
            long long bq = I64_MIN;
            int tq = 0;
            if (from) {
                const uint4 h = in[lane];
                bq = join64(h.y, h.x);
                tq = static_cast<int>(h.z);
            }
            const long long top = warp_max64(bq);
            if (bq != top) tq = 0;
            const int incl = warp_incl_scan(tq);
            const int all = __shfl_sync(FULL, incl, 31);
            const int idx = static_cast<int>(rr % static_cast<uint32_t>(all));
            const unsigned hit = __ballot_sync(FULL, tq > 0 && idx >= incl - tq && idx < incl);
            const int owner = __ffs(hit) - 1;
            int k = idx - __shfl_sync(FULL, incl - tq, owner);
            // rank k among the owner's ballots, 32 at a time (lane j: ballot j)
            const uint32_t* ob = reinterpret_cast<const uint32_t*>(in);
            int node = -1;
            for (int e0 = 0; e0 < ENTS && node < 0; e0 += 32) {
                const int e = e0 + lane, wd = e + 3;  // word of ballot e
                const unsigned bal = e < ENTS ? ob[((wd >> 2) * CS + owner) * 4 + (wd & 3)] : 0u;
                const int n = __popc(bal);
                const int in_ = warp_incl_scan(n);
                const unsigned got = __ballot_sync(FULL, k >= in_ - n && k < in_);
                if (got) {
                    const int src = __ffs(got) - 1;
                    int pos = 0;
                    if (lane == src)
                        pos = owner * L + (e / NW) * BT + (e % NW) * 32 + nth_set_bit(bal, k - (in_ - n));
                    node = __shfl_sync(FULL, pos, src);
                } else {
                    k -= __shfl_sync(FULL, in_, 31);
                }
            }
            ch = node;
        }
        if (n_feas >= 2) ++rr;
        if (rank == 0 && tid == 0) p.chosen[i] = ch;
        PHASE(8);  // (b) tie pick

        // ---- commit: each block writes only the columns it owns ----
        if (ch >= 0) {
            const int owner = ch / L, lcc = ch - owner * L;
            if (owner == rank) {
                if (tid == lcc % BT) {
                    for (int r = 0; r < R; ++r) req(r, lcc) += sg[r];
                    nz(0, lcc) += sg[R];
                    nz(1, lcc) += sg[R + 1];
                    cnt(0, lcc) += 1;
                    if (p.use_vols) {
                        for (int s = 0; s < W; ++s) {
                            const int packed = pvol[s];
                            if (!(packed & 1)) continue;
                            const int vid = packed >> 6, kind = (packed >> 3) & 7;
                            const int ro = (packed >> 2) & 1, co = (packed >> 1) & 1;
                            uint8_t& cell = volf(vid, lcc);
                            const int was_any = cell & 1;
                            // count-only slots read the always-empty sentinel
                            // row and never write occupancy
                            if (!co) cell = static_cast<uint8_t>(cell | 1 | (ro ? 0 : 2));
                            if (kind < K && !was_any) nk(kind, lcc) += 1;
                        }
                    }
                }
                if (p.use_ports)
                    for (int q = tid; q < PV; q += BT)
                        if (q < PQ ? gports[q] : gports_far[q]) ports(q, lcc) = 1;
                const int32_t* inc = inc_shared ? s_inc + b * G4 : p.spread_inc_t + (size_t)gid * G4;
                for (int h = tid; h < G; h += BT) {
                    const int v = inc[h];
                    if (v) spread(h, lcc) += v;
                }
                stale = lcc;  // its resource scores, from the new nonzero requests
            }
            for (int a = 0; a < tcount; ++a) {
                const int32_t* te = terms + a * TERM_FIELDS;
                const int m = te[1], own = te[4];
                if (!m && !own) continue;
                const int t = te[0];
                // the chosen node's domain, from its owner's copy of the rows
                const int32_t* dv = SH || p.off[P_DOM_VALID] >= 0
                    ? cluster.map_shared_rank(&dom_valid(t, lcc), owner) : p.dom_valid + (size_t)t * NS + ch;
                const int32_t* nd = SH || p.off[P_NODE_DOMAIN] >= 0
                    ? cluster.map_shared_rank(&node_domain(t, lcc), owner) : p.node_domain + (size_t)t * NS + ch;
                const int valid = *dv, d = *nd;  // one round trip for both
                if (valid) {
#pragma unroll
                    for (int c = 0; c < CPT; ++c) {
                        const int lc = c * BT + tid;
                        if (lc < L && dom_valid(t, lc) && node_domain(t, lc) == d) {
                            dm(t, lc) += m;
                            downer(t, lc) += own;
                        }
                    }
                }
                if (tid == 0) s_total[t] += m;
            }
        }
        __syncthreads();
        PHASE(9);  // commit
    }
#ifdef FUSED_SCAN_PHASES
    if (clocked)
        for (int k = 0; k < NPHASES; ++k) g_phases[k] = phase_acc[k];
#endif
    if (rank == 0 && tid == 0) p.rr_out[0] = static_cast<int32_t>(rr);
    // no block leaves while another may still send to it
    cluster_arrive();
    cluster_wait();
}

template <int CPT, bool SH, bool BZ>
int launch(const ScanParams& params, cudaStream_t stream, int* max_clusters, int* static_smem) {
    auto kernel = fused_scan_kernel<CPT, SH, BZ>;
    cudaFuncAttributes fa = {};
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (static_smem) *static_smem = static_cast<int>(fa.sharedSizeBytes);
    // the planner reserved too little for the static arrays
    if (static_cast<int>(fa.sharedSizeBytes) + params.smem_bytes > optin) return -3;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, params.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(params.cs, 1, 1);
    cfg.blockDim = dim3(params.threads, 1, 1);
    cfg.dynamicSmemBytes = params.smem_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = params.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_clusters) *max_clusters = clusters;
    if (clusters < 1) return -4;  // not even one cluster of this size can be placed
    if (!stream && max_clusters) return 0;  // a query, no launch
    err = cudaLaunchKernelEx(&cfg, kernel, params);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int dispatch(const ScanParams* p, cudaStream_t s, int* max_clusters, int* static_smem) {
    const int nw = p->threads / 32;
    const bool bz = p->num_zones > REG_ZONES;
    const bool zg = p->zbuf != nullptr;
    if (p->r > MAX_R || p->t > MAX_TERMS || p->w > MAX_SLOTS || p->k > MAX_KINDS ||
        p->num_zones < 0 || p->cs < 1 || p->cs > MAX_CLUSTER || p->threads < 32 ||
        p->threads > MAX_THREADS || p->threads % 32 || p->cols % 16 || p->ns != p->cs * p->cols ||
        p->cols > p->threads * p->cpt || nw * p->cpt > MAX_CPT * MAX_WARPS || p->sw % 4 ||
        p->sws % 4 || p->sws > p->sw || p->sws < p->r + 4 + TERM_FIELDS * p->t ||
        p->g4 % 4 || p->w4 % 4 || p->w4 < p->w || p->g4 < p->g || p->msg_a % 4 ||
        (zg ? p->msg_a != 12 : p->msg_a < 10 + 2 * p->num_zones) || (!bz && p->msg_a > MAX_MSG_A) ||
        p->msg_b % 4 ||
        p->msg_b < 3 + p->cpt * nw || (zg && !bz) ||
        (bz && !zg && (p->zone_off % 16 || p->zone_off + 16 * p->num_zones > p->smem_bytes)))
        return -1;
    if (bz) {  // more zones than registers hold: the zone statistics in shared or global memory
        switch (p->cpt) {
            case 1: return launch<1, false, true>(*p, s, max_clusters, static_smem);
            case 2: return launch<2, false, true>(*p, s, max_clusters, static_smem);
            case 4: return launch<4, false, true>(*p, s, max_clusters, static_smem);
            case 8: return launch<8, false, true>(*p, s, max_clusters, static_smem);
            case 16: return launch<16, false, true>(*p, s, max_clusters, static_smem);
            default: return -2;
        }
    }
    bool all_shared = true;
    for (int k = 0; k < NPLANES; ++k) all_shared = all_shared && p->off[k] >= 0;
    // segments whose planes all fit in shared memory are small: 1 or 2 columns a thread
    if (all_shared && p->cpt == 1) return launch<1, true, false>(*p, s, max_clusters, static_smem);
    if (all_shared && p->cpt == 2) return launch<2, true, false>(*p, s, max_clusters, static_smem);
    switch (p->cpt) {
        case 1: return launch<1, false, false>(*p, s, max_clusters, static_smem);
        case 2: return launch<2, false, false>(*p, s, max_clusters, static_smem);
        case 4: return launch<4, false, false>(*p, s, max_clusters, static_smem);
        case 8: return launch<8, false, false>(*p, s, max_clusters, static_smem);
        case 16: return launch<16, false, false>(*p, s, max_clusters, static_smem);
        default: return -2;
    }
}

}  // namespace

#ifdef FUSED_SCAN_PHASES
extern "C" int fused_scan_read_phases(unsigned long long* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)));
}
#endif

extern "C" int fused_scan_launch(const ScanParams* params, void* stream) {
    return dispatch(params, static_cast<cudaStream_t>(stream), nullptr, nullptr);
}

// The plan as the card sees it, without a launch: how many clusters of
// this size fit at once, and the kernel's static shared memory.
extern "C" int fused_scan_query(const ScanParams* params, int* max_clusters, int* static_smem) {
    return dispatch(params, nullptr, max_clusters, static_smem);
}
