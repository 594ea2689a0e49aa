// The sharded segment scan for Hopper (sm_90a): the sequential-greedy
// filter -> score -> selectHost -> commit loop over one segment's pods with
// the node axis split into S equal shards, each shard a thread-block cluster.
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
//   gathered from every shard, and every block derives the same chosen
//   node: the (rr % ties)-th tie in GLOBAL column order (shard-major, then
//   the shard's column), as _ax_first_true and the cross-shard tie prefix
//   do; only the block that owns the node commits its columns, every block
//   moves the affinity-domain counters of its own columns.
//
// Design. The earlier design ran S x B blocks of one cooperative launch with
// the planes in global memory and two grid barriers a pod (an arrival
// counter and a generation word), every block reading every block's
// messages from L2: 19.96 us a pod on the main segment in 4 shards on an
// H100 80GB HBM3 at 700 W, 3x the fused scan. Each point below answers one
// of its costs; the block-level code is fused_scan.cu's (its design points
// in brackets), repeated here so that its source, build and timings stay as
// they are.
//  1. A shard is a thread-block cluster. One grid of S clusters of cs <= 16
//     blocks (a non-portable size), launched by cudaLaunchKernelEx with the
//     cluster dimension and the cooperative attribute: cluster s owns shard
//     s, its block rank r the columns [r*cols, (r+1)*cols), each thread CPT
//     of them (c*threads + tid). Blocks wait on blocks of other clusters,
//     so every cluster must be resident at once: the planner
//     (mesh_scan.plan) takes the largest cs for which
//     cudaOccupancyMaxActiveClusters holds S clusters of the plan's shape,
//     the host entry refuses a launch the card cannot hold (-4) and the
//     cooperative attribute has the runtime refuse a grid it cannot
//     co-schedule (CUDA 12.8 on an H100 takes the attribute beside the
//     cluster dimension); a refused launch raises on the host. Every wait also
//     traps after WAIT_LIMIT_CYCLES, so a fault ends the launch, not the
//     process.
//  2. State in shared memory [1]. At launch each block bulk-copies
//     (cp.async.bulk on an mbarrier, one copy a row) its slice of every
//     plane of its shard that the planner placed in shared memory; planes
//     that did not fit are read in global memory through the same view (a
//     base pointer and a row stride). The frontier loop's refresh reads each
//     shard's state planes after every chunk, so every launch writes its
//     shared copies back at its end.
//  3. The next pods' inputs in flight [2] and cached resource scores [6]:
//     while pod i computes, one thread bulk-copies pod i+2's signature row,
//     volume slots, spread increments and the block's slice of its five
//     static score rows; a column's least/most/balanced scores are kept per
//     (signature, column) in the res plane and recomputed at its commit.
//  4. Two exchanges a pod, (a) the statistics and (b) the best score and
//     its ties, each in two stages and neither with a barrier.
//     Inside the cluster [3]: each block's last warp folds its warps' parts
//     and sends the block's message with st.async into slot [rank] of block
//     rank 0's inbox, whose mbarrier the bytes complete (rank 0 waits on it,
//     with acquire at cluster scope). The other ranks need no inbox: what
//     every block needs is the fold over every shard, which only stage two
//     gives, so a star costs cs messages where all-to-all costs cs^2.
//     Between clusters: warp 0 of rank 0 folds its cluster's inbox into the
//     shard's one message, writes it into slot [pod parity][shard] of a
//     global mailbox and stamps it with the pod's sequence number (the
//     launch epoch, the pod) by st.release.gpu after a warp barrier; warp 0
//     of every block reads the S slots (lane q: shard q), spinning with
//     ld.acquire.gpu until the stamp is the pod's, folds them, and hands the
//     result to its block through shared memory. No arrival counter,
//     generation word or grid barrier is left. (b)'s shard message carries
//     the shard's best, its tie count, each of its blocks' tie count at that
//     best (zero for a block below it) and their tie ballots, so a block
//     decodes the chosen global column from the mailbox alone: the shard by
//     a prefix over the shards' counts, the block by a prefix over that
//     shard's blocks, the column by the k-th set bit of that block's
//     ballots, in node order (column round, warp, lane) inside a block.
//     Why no shard overwrites slot i % 2 while another still reads it: a
//     shard writes its pod i+2 message only after its rank 0 has read every
//     shard's pod i+1 (b) message [for (a)] or pod i+2 (a) message [for
//     (b)], and each of those was written only after every block of its
//     shard had sent its own message of that pod, which it does after it
//     has finished reading pod i's slots. So the writer of pod i+2 is a
//     whole pod behind every reader of pod i, and a stamp read equal to the
//     pod's stays the pod's while its reader reads the payload. Rank 0's
//     inboxes are double-buffered by pod parity the same way: a block sends
//     its pod i+2 message after reading its shard's pod i+1 message, which
//     rank 0 wrote after it had folded pod i's inbox and re-armed its
//     mbarrier. A stamp from an earlier launch on the same buffers never
//     matches: the epoch word, read by every block at entry and advanced by
//     block 0 at the end, is in the stamp's high half.
//     A non-owning shard moves its own columns' affinity-domain counters
//     with the chosen node's domain ids, which are static: read from the
//     owner shard's global plane, no third exchange.
//  5. Zones [5]. Up to REG_ZONES zones, each thread keeps its columns' zone
//     sums in registers and they travel in the messages (2 words a zone).
//     More: each block adds its columns' spread counts into its shard's row
//     of a global scratch (zbuf, by pod parity) with 64-bit atomics, fenced
//     before its cluster message; after exchange (a) every block folds the
//     S rows into its zone totals, in shared memory where the planner placed
//     them (zone_off) or else in the block's own global row. Rank 0 clears
//     its shard's row of pod i once exchange (b) of pod i shows that every
//     block has folded it (each sent its (b) message after its fold), and
//     before its pod i+1 message, which every block of the shard reads
//     before it adds pod i+2's sums there. No zone count is refused.
//     A signature row keeps its first 256 port flags in shared memory (sws);
//     a wider row's other flags are read from global memory [7].
//  6. The frontier loop (ops/frontier.py) launches it a chunk at a time with
//     the fused scan's control words: the counter in and out (ctl[CTL_RR]),
//     the stop flag (every block returns before touching anything once a
//     refresh has raised it), the chunk cursor.
//  7. Shards in several launches (a mesh over several cards, one launch a
//     card; on one card, two launches on two streams where the mesh says
//     so: parallel/mesh.py Mesh.groups). No launch spans two cards, so a
//     launch takes the shards [shard_lo, shard_lo + shards_here) and the
//     launches exchange through mailboxes across them. Each launch has its
//     own copy of the tables, chosen, the control words, the epoch and an
//     inbox of every shard's slot (mailbox slots keep the global shard id);
//     rank 0 of a shard pushes its (a) and (b) messages into every launch's
//     inbox (its own card's locally, the others' by peer pointer: a remote
//     store is posted, a remote poll would cost a round trip a try) and
//     publishes each stamp with st.release.sys after a warp barrier; readers
//     poll only their own inbox, with ld.acquire.sys. The cross-launch
//     rounds use the system scope on one card too, so that the one-card run
//     executes what several cards do. Past the register zones the shard's
//     row of zone sums travels with its (a) message, into every other
//     launch's scratch. The owner shard's domain rows are read through its
//     pointer, a peer read from another card. Every launch reads and
//     advances its own epoch, counter and cursor, equal on every launch
//     because each is a function of folded values. The double-buffering
//     argument of point 4 holds as it is: a shard writes pod i+2's slots
//     only after reading every shard's pod i+1 message, which each shard
//     sent after its blocks had read pod i's slots in their own inbox. The
//     launches must all run at once: the host enqueues each on a stream of
//     its own, and a launch whose partners never run ends at the waits'
//     trap. This path is a build of its own (the FAR instantiations), so
//     the one-launch build (the default on one card) keeps point 4's code.
//
// What bounds it: latency, as the fused scan. A pod's chain is the fused
// scan's block chain with each exchange's cluster stage followed by one
// mailbox round through L2 (a release store that waits for the payload, the
// readers' acquire poll, the payload's trip; (b) one trip more for the
// owner block's ballots): 11.1 us a pod on the main segment in 4 shards
// (64 blocks) on an H100 80GB HBM3 at 700 W, the two mailbox rounds 5.5 us
// of it. Build with -DMESH_SCAN_PHASES for a clock64 split of that chain
// (scripts/mesh_scan_phases.py reads it; PERF.md section 5).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_SHARDS = 16;
constexpr int MAX_CPT = 16;
constexpr int REG_ZONES = 8;   // zones whose sums a thread keeps in registers
constexpr int MAX_TERMS = 128;
constexpr int MAX_SLOTS = 8;
constexpr int MAX_KINDS = 4;
constexpr int MAX_R = 8;
constexpr int TERM_FIELDS = 9;  // t, m_g, own_ra, own_raa, own_all, own_w, sym_w*m_g, m_g&&is_raa, self_match
constexpr int POD_ROWS = 5;     // static_ok, aff_raw, taint_raw, score_raw, interpod_raw
constexpr int NBUF = 3;         // pod input buffers: pod i+2 is fetched while pod i runs
constexpr int MAX_MSG_A = 28;   // words of a statistics message: 10 + 2 a register zone, padded to 4
constexpr int HEAD_A = 4;       // words of a shard's (a) slot before its message: the stamp, 2 unused
constexpr int HEAD_B = 8;       // of a (b) slot before its blocks' tie counts: stamp, best, ties, 3 unused
constexpr int NGLOB = 8 + REG_ZONES;  // a pod's statistics over every shard, then the register zones' sums
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
    S_DOWNER, S_VOLF, S_NK, S_RES, NSHARD_PLANES
};

// Placement slots of MeshParams::off, in the planner's order
// (fused_scan.PLANES): the byte offset of the plane in dynamic shared
// memory, or -1 where it stays in global memory.
enum Plane {
    P_POD = 0, P_INC, P_REQ, P_NZ, P_CNT, P_PORTS, P_DM, P_DOWNER, P_VOLF, P_NK,
    P_SPREAD, P_RES, P_ALLOC, P_ALLOC_PODS, P_EXISTS, P_ZONE, P_NODE_DOMAIN, P_DOM_VALID,
    NPLANES
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
    // between clusters: each shard's message by pod parity, and the launch epoch
    uint32_t* mbox_a;             // [2][S][box_a]
    uint32_t* mbox_b;             // [2][S][box_b]
    int32_t* epoch;               // [1], zero at first use, advanced by every launch that runs
    // past REG_ZONES zones: [2][S][num_zones] shard rows by pod parity (zero
    // at first use and left zero), then, with no zone_off, [S*cs][num_zones]
    // zone totals a block; else null
    int64_t* zbuf;
    // the frontier loop's control words
    int32_t* rr;                  // the counter, in and out
    const int32_t* stop;
    int32_t* cursor;
    // a mesh in several launches: every launch's mbox_a, mbox_b and zbuf
    // ([groups][3], this launch's among them), on this launch's card
    const int64_t* peers;
    int32_t shards_n, n_local, ns, cols, cs, threads, cpt;
    int32_t g, g4, t, pv, v, r, w, w4, k, sw, sws;  // sws: ints of a signature row in shared memory
    int32_t p_real, num_zones, use_terms, use_vols, use_ports, smem_bytes;
    int32_t gnz_off, inbox_a_off, inbox_b_off, msg_a, msg_b, box_a, box_b;  // the planner's layout
    int32_t zone_off;  // the zone totals in shared memory (num_zones int64), or -1
    // this launch's shards [shard_lo, shard_lo + shards_here) of the mesh's
    // shards_n, the launches (groups) and this one's index, and the clusters
    // that must be resident at once on this launch's card (every launch's
    // that shares it)
    int32_t shard_lo, shards_here, groups, group, resident;
    int32_t wt[7];     // least, most, balanced, spread, node_affinity, taint, interpod
    int32_t off[18];   // NPLANES placement offsets
};

}  // extern "C"

namespace {

static_assert(sizeof(((MeshParams*)0)->off) / sizeof(int32_t) == NPLANES, "off[] has one slot a plane");

// ---- the fused scan's exact integer arithmetic ----

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

// ---- warp reductions of 64-bit values on the redux.sync unit ----

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

// ---- Hopper primitives: mbarriers, bulk copies, cluster stores, the mailbox ----

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

// global -> this block's shared memory; bytes and both addresses are
// multiples of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Four words into block `rank`'s shared memory at the address `local`
// has in this block, completing 16 bytes on that block's copy of `bar`.
__device__ __forceinline__ void send4(const void* local, const uint64_t* bar, int rank, uint32_t w0,
                                      uint32_t w1, uint32_t w2, uint32_t w3) {
    uint32_t ra, rb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(smem_addr(local)), "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
        :: "r"(ra), "r"(w0), "r"(w1), "r"(w2), "r"(w3), "r"(rb) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A mailbox slot's stamp: published by a release store once the payload is
// written, read with acquire until it is the pod's.
__device__ __forceinline__ void stamp_release(uint32_t* slot, unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;\n" :: "l"(slot), "l"(v) : "memory");
}

__device__ __forceinline__ void stamp_wait(const uint32_t* slot, unsigned long long want) {
    const long long start = clock64();
    for (;; wait_guard(start)) {
        unsigned long long v;
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(slot) : "memory");
        if (v == want) return;
    }
}

// The same across launches, which may be on other cards: the payload is
// pushed into every launch's inbox (peer stores for another card's), and
// each stamp is published and polled at system scope, on one card too
// (.gpu would pass there and be wrong between two cards). The release is
// cumulative: the warp barrier before it orders every lane's payload
// stores ahead of it, so no separate fence is needed.
__device__ __forceinline__ void stamp_release_sys(uint32_t* slot, unsigned long long v) {
    asm volatile("st.release.sys.global.u64 [%0], %1;\n" :: "l"(slot), "l"(v) : "memory");
}

__device__ __forceinline__ void stamp_wait_sys(const uint32_t* slot, unsigned long long want) {
    const long long start = clock64();
    for (;; wait_guard(start)) {
        unsigned long long v;
        asm volatile("ld.acquire.sys.global.u64 %0, [%1];\n" : "=l"(v) : "l"(slot) : "memory");
        if (v == want) return;
    }
}

// launch g's inboxes and zone scratch (MeshParams::peers)
__device__ __forceinline__ uint32_t* peer_box(const MeshParams& p, int g, int which) {
    return reinterpret_cast<uint32_t*>(p.peers[3 * g + which]);
}

// rows of each placed plane at this segment's shapes (0 = the kernel never
// reads it), and the shard plane that holds it in global memory
__device__ __forceinline__ int plane_rows(const MeshParams& p, int k) {
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

__device__ __forceinline__ int shard_plane(int k) {
    switch (k) {
        case P_REQ: return S_REQ;
        case P_NZ: return S_NZ;
        case P_CNT: return S_CNT;
        case P_PORTS: return S_PORTS;
        case P_DM: return S_DM;
        case P_DOWNER: return S_DOWNER;
        case P_VOLF: return S_VOLF;
        case P_NK: return S_NK;
        case P_SPREAD: return S_SPREAD;
        case P_RES: return S_RES;
        case P_ALLOC: return S_ALLOC;
        case P_ALLOC_PODS: return S_ALLOC_PODS;
        case P_EXISTS: return S_EXISTS;
        case P_ZONE: return S_ZONE;
        case P_NODE_DOMAIN: return S_NODE_DOMAIN;
        default: return S_DOM_VALID;
    }
}

// A plane as this block sees it: its first column, and its row stride.
template <typename T>
struct View {
    T* at;
    int stride;
    __device__ __forceinline__ T& operator()(int row, int col) const { return at[row * stride + col]; }
};

template <typename T>
__device__ __forceinline__ View<T> view(const void* global, int off, unsigned char* smem, int base, int cols,
                                        int ns) {
    if (off >= 0) return View<T>{reinterpret_cast<T*>(smem + off), cols};
    return View<T>{const_cast<T*>(static_cast<const T*>(global)) + base, ns};
}

// Phase clock: built with -DMESH_SCAN_PHASES, thread 0 of block 0 (rank 0
// of shard 0) sums clock64() deltas per phase over the pods
// (scripts/mesh_scan_phases.py reads them); compiled out otherwise.
#ifdef MESH_SCAN_PHASES
constexpr int NPHASES = 10;
__device__ unsigned long long g_phases[NPHASES];
#define PHASE(k) do { if (clocked) { const long long t_ = clock64(); phase_acc[k] += t_ - phase_t; phase_t = t_; } } while (0)
#else
#define PHASE(k) do { } while (0)
#endif

// FAR: the shards in several launches (design point 7), a build of its own
// so that the one-launch build keeps point 4's code as it was
template <int CPT, bool FAR>
__global__ void __launch_bounds__(MAX_THREADS, 1) mesh_scan_kernel(const MeshParams p) {
    cg::cluster_group cluster = cg::this_cluster();
#ifdef MESH_SCAN_PHASES
    const bool clocked = blockIdx.x == 0 && threadIdx.x == 0 && p.group == 0;
    long long phase_acc[NPHASES] = {};
    long long phase_t = clock64();
#endif
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ uint64_t s_bar[1 + NBUF];  // state load; one per pod buffer
    __shared__ uint64_t s_xa[2];          // rank 0: its cluster's (a) inbox complete, by pod parity
    __shared__ uint64_t s_xb[2];          // rank 0: the (b) inbox, by pod parity
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
    __shared__ const void* s_pl[NSHARD_PLANES];  // this block's shard's planes
    __shared__ long long s_glob[NGLOB];          // the pod's statistics over every shard
    __shared__ int s_ch;                         // the chosen global column

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int BT = blockDim.x, NW = BT >> 5;
    const int CS = p.cs, L = p.cols, NS = p.ns, S = p.shards_n, NL = p.n_local;
    const int rank = static_cast<int>(cluster.block_rank());
    const int shard = p.shard_lo + static_cast<int>(blockIdx.x) / CS;  // global
    constexpr bool far = FAR;  // the shards in several launches: mailboxes across them
    const int base = rank * L;
    const int R = p.r, T = p.t, G = p.g, PV = p.pv, W = p.w, K = p.k;
    const int SW = p.sw, SWS = p.sws, G4 = p.g4, W4 = p.w4, MA = p.msg_a, MB = p.msg_b;
    const int BA = p.box_a, BB = p.box_b;
    const int NZ = p.num_zones;
    const bool zrows = NZ > REG_ZONES;  // the zone sums in the shard rows of zbuf
    const int NZR = zrows ? 0 : NZ;     // zones in registers and in the messages
    long long* const zbuf = reinterpret_cast<long long*>(p.zbuf);
    // a signature's port flags in its shared row, and where the rest start
    // in its global row
    const int PORT0 = R + 4 + TERM_FIELDS * T;
    const int PQ = PV < SWS - PORT0 ? PV : SWS - PORT0;
    const bool wt_ip = p.wt[6] != 0;
    const int ENTS = CPT * NW;  // tie ballots a block sends
    const uint32_t bytes_a = CS * MA * 4, bytes_b = CS * MB * 4;

    // dynamic shared memory: [sig NBUF x sws][pod_vol NBUF x w4] at 0, the
    // nonzero requests of every signature [g4 x 2], rank 0's two inboxes,
    // the zone totals (zone_off), then the placed planes
    int32_t* s_sig = reinterpret_cast<int32_t*>(smem);
    int32_t* s_pvol = s_sig + NBUF * SWS;
    int32_t* s_gnz = reinterpret_cast<int32_t*>(smem + p.gnz_off);
    // inboxes [2][chunk][CS] of 16-byte chunks: lane q reads block q's
    // chunk k without bank conflicts
    uint4* s_ina = reinterpret_cast<uint4*>(smem + p.inbox_a_off);
    uint4* s_inb = reinterpret_cast<uint4*>(smem + p.inbox_b_off);
    const bool pod_rows_shared = p.off[P_POD] >= 0;
    const bool inc_shared = p.off[P_INC] >= 0;
    int32_t* s_pod = pod_rows_shared ? reinterpret_cast<int32_t*>(smem + p.off[P_POD]) : nullptr;
    int32_t* s_inc = inc_shared ? reinterpret_cast<int32_t*>(smem + p.off[P_INC]) : nullptr;
    // past REG_ZONES: the mesh's zone totals, in shared memory or this block's global row
    long long* const ztot = !zrows ? nullptr
        : p.zone_off >= 0 ? reinterpret_cast<long long*>(smem + p.zone_off)
                          : zbuf + (size_t)2 * S * NZ + (size_t)blockIdx.x * NZ;

    // a compaction is wanted (frontier loop): this chunk waits for the
    // host; every block reads the same flag, so all return together
    if (*p.stop != 0) return;

    if (tid < NSHARD_PLANES)
        s_pl[tid] = reinterpret_cast<const void*>(p.shards[(size_t)shard * NSHARD_PLANES + tid]);
    if (tid == 0) {
        for (int b = 0; b < 1 + NBUF; ++b) mbar_init(&s_bar[b]);
        for (int b = 0; b < 2; ++b) {
            mbar_init(&s_xa[b]);
            mbar_init(&s_xb[b]);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (rank == 0)  // the first two pods' inboxes (parities 0 and 1)
            for (int b = 0; b < 2; ++b) {
                mbar_expect_tx(&s_xa[b], bytes_a);
                mbar_expect_tx(&s_xb[b], bytes_b);
            }
    }
    for (int t = tid; t < T; t += BT) s_total[t] = p.total[t];
    if (tid < K) s_vlim[tid] = p.vol_limits[tid];
    if (tid < 4) s_done[tid] = 0;
    for (int h = tid; h < G; h += BT) {
        s_gnz[2 * h] = p.sig[(size_t)h * SW + R];
        s_gnz[2 * h + 1] = p.sig[(size_t)h * SW + R + 1];
    }
    // the counter and the epoch, read by every block before any block's
    // first message (block 0 writes both back after its last pod)
    uint32_t rr = static_cast<uint32_t>(*p.rr);
    const unsigned long long epoch = static_cast<unsigned long long>(static_cast<uint32_t>(*p.epoch)) + 1;
    __syncthreads();

    const View<int32_t> req = view<int32_t>(s_pl[S_REQ], p.off[P_REQ], smem, base, L, NS);
    const View<int32_t> nz = view<int32_t>(s_pl[S_NZ], p.off[P_NZ], smem, base, L, NS);
    const View<int32_t> cnt = view<int32_t>(s_pl[S_CNT], p.off[P_CNT], smem, base, L, NS);
    const View<int32_t> ports = view<int32_t>(s_pl[S_PORTS], p.off[P_PORTS], smem, base, L, NS);
    const View<int32_t> dm = view<int32_t>(s_pl[S_DM], p.off[P_DM], smem, base, L, NS);
    const View<int32_t> downer = view<int32_t>(s_pl[S_DOWNER], p.off[P_DOWNER], smem, base, L, NS);
    const View<uint8_t> volf = view<uint8_t>(s_pl[S_VOLF], p.off[P_VOLF], smem, base, L, NS);
    const View<int32_t> nk = view<int32_t>(s_pl[S_NK], p.off[P_NK], smem, base, L, NS);
    const View<int32_t> spread = view<int32_t>(s_pl[S_SPREAD], p.off[P_SPREAD], smem, base, L, NS);
    const View<uint16_t> res = view<uint16_t>(s_pl[S_RES], p.off[P_RES], smem, base, L, NS);
    const View<const int32_t> alloc = view<const int32_t>(s_pl[S_ALLOC], p.off[P_ALLOC], smem, base, L, NS);
    const View<const int32_t> alloc_pods =
        view<const int32_t>(s_pl[S_ALLOC_PODS], p.off[P_ALLOC_PODS], smem, base, L, NS);
    const View<const int32_t> exists = view<const int32_t>(s_pl[S_EXISTS], p.off[P_EXISTS], smem, base, L, NS);
    const View<const int32_t> zone = view<const int32_t>(s_pl[S_ZONE], p.off[P_ZONE], smem, base, L, NS);
    const View<const int32_t> node_domain =
        view<const int32_t>(s_pl[S_NODE_DOMAIN], p.off[P_NODE_DOMAIN], smem, base, L, NS);
    const View<const int32_t> dom_valid =
        view<const int32_t>(s_pl[S_DOM_VALID], p.off[P_DOM_VALID], smem, base, L, NS);
    const int32_t* g_rows[POD_ROWS] = {
        static_cast<const int32_t*>(s_pl[S_STATIC_OK]), static_cast<const int32_t*>(s_pl[S_AFF]),
        static_cast<const int32_t*>(s_pl[S_TAINT]), static_cast<const int32_t*>(s_pl[S_SCORE]),
        static_cast<const int32_t*>(s_pl[S_INTERPOD])};

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
            const unsigned char* src = static_cast<const unsigned char*>(s_pl[shard_plane(k)]);
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

    // this block's column that took a pod at the last commit, or -1: its
    // resource scores are refreshed during the next pod's exchanges
    int stale = -1;
    for (int i = 0; i < p.p_real; ++i) {
        const int b = i % NBUF, par = i & 1;
        const uint32_t xpar = (i >> 1) & 1;
        const unsigned long long seq = (epoch << 32) | static_cast<unsigned>(i + 1);
        mbar_wait(&s_bar[1 + b], (i / NBUF) & 1);
        const int gid = s_gid[b];
        const int32_t* sg = s_sig + b * SWS;
        const int32_t* terms = sg + R + 4;
        const int32_t* gports = sg + PORT0;
        const int32_t* gports_far = p.sig + (size_t)gid * SW + PORT0;  // flags PQ.. of a wide row
        // past REG_ZONES: this shard's row of the pod's zone sums
        long long* zrow = zrows ? zbuf + ((size_t)par * S + shard) * NZ : nullptr;
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
                        if (kk < K && has_kind[kk] && nk(kk, lc) + count_new[kk] > s_vlim[kk]) f = false;
                }
                if (f) {
                    nf += 1;
                    if (z >= 0) {
                        nzc += 1;
                        if (zrows) {
                            if (z < NZ)
                                atomicAdd(reinterpret_cast<unsigned long long*>(&zrow[z]),
                                          static_cast<unsigned long long>(static_cast<long long>(sc)));
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

        // ---- exchange (a), in the cluster: the block's statistics to rank 0 ----
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
#pragma unroll
            for (int zz = 0; zz < REG_ZONES; ++zz)
                if (zz < NZR) zsum[zz] = warp_sum64(zsum[zz]);
            // the warp's zone atomics, in global memory, before its lane 0
            // counts it done (and so before its shard's message)
            if (zrows) __threadfence();
            __syncwarp();
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
#pragma unroll
                for (int zz = 0; zz < REG_ZONES; ++zz)
                    if (zz < NZR) {
                        pa[10 + 2 * zz][warp] = static_cast<uint32_t>(zsum[zz]);
                        pa[11 + 2 * zz][warp] = static_cast<uint32_t>(zsum[zz] >> 32);
                    }
            }
            if (last_warp(&s_done[par], NW)) {
                // the block's message, folded over its warps' parts (lane w
                // reads warp w's); lane j sends its chunk j to rank 0
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
#pragma unroll
                for (int zz = 0; zz < REG_ZONES; ++zz)
                    if (zz < NZR) {
                        const long long v = warp_sum64(has ? join64(pa[11 + 2 * zz][lane], pa[10 + 2 * zz][lane]) : 0);
                        m[10 + 2 * zz] = static_cast<uint32_t>(v);
                        m[11 + 2 * zz] = static_cast<uint32_t>(v >> 32);
                    }
                if (lane == 0) s_done[par] = 0;  // for pod i+2
#pragma unroll
                for (int q = 0; q < MAX_MSG_A; q += 4)
                    if (q < MA && lane == q / 4)
                        send4(&s_ina[(par * (MA / 4) + q / 4) * CS + rank], &s_xa[par], 0, m[q], m[q + 1],
                              m[q + 2], m[q + 3]);
            }
        }
        // the stale column's score for this pod's signature, by the thread
        // that reads it in the totals below (the other signatures' follow
        // in exchange (b)'s wait)
        if (stale >= 0 && tid == stale % BT)
            res(gid, stale) = static_cast<uint16_t>(res_score((long long)nz(0, stale) + s_gnz[2 * gid],
                                                              (long long)nz(1, stale) + s_gnz[2 * gid + 1],
                                                              alloc(0, stale), alloc(1, stale)));
        PHASE(2);  // (a) sent, stale score refreshed

        // ---- exchange (a) between clusters: one stamped message a shard ----
        if (warp == 0) {
            if (rank == 0) {
                mbar_wait_cluster(&s_xa[par], xpar);
                if (lane == 0) mbar_expect_tx(&s_xa[par], bytes_a);  // for pod i+2
                PHASE(3);  // (a) cluster wait
                // the cluster's messages (lane q: block q's), folded into the
                // shard's, which every lane then holds
                const bool from = lane < CS;
                uint32_t xa[MAX_MSG_A];
#pragma unroll
                for (int q = 0; q < MAX_MSG_A; q += 4) {
                    uint4 v = make_uint4(0, 0, 0, 0);
                    if (q < MA && from) v = s_ina[(par * (MA / 4) + q / 4) * CS + lane];
                    xa[q] = v.x;
                    xa[q + 1] = v.y;
                    xa[q + 2] = v.z;
                    xa[q + 3] = v.w;
                }
                uint32_t m[MAX_MSG_A];
#pragma unroll
                for (int q = 0; q < MAX_MSG_A; ++q) m[q] = 0;
                m[0] = __reduce_add_sync(FULL, xa[0]);
                m[1] = __reduce_add_sync(FULL, xa[1]);
#pragma unroll
                for (int q = 2; q < 5; ++q)
                    m[q] = static_cast<uint32_t>(__reduce_max_sync(FULL, static_cast<int>(xa[q])));
                if (wt_ip) {
                    const long long hi = warp_max64(from ? join64(xa[7], xa[6]) : I64_MIN);
                    const long long lo = warp_min64(from ? join64(xa[9], xa[8]) : I64_MAX);
                    m[6] = static_cast<uint32_t>(hi);
                    m[7] = static_cast<uint32_t>(hi >> 32);
                    m[8] = static_cast<uint32_t>(lo);
                    m[9] = static_cast<uint32_t>(lo >> 32);
                }
#pragma unroll
                for (int zz = 0; zz < REG_ZONES; ++zz)
                    if (zz < NZR) {
                        const long long v = warp_sum64(join64(xa[11 + 2 * zz], xa[10 + 2 * zz]));
                        m[10 + 2 * zz] = static_cast<uint32_t>(v);
                        m[11 + 2 * zz] = static_cast<uint32_t>(v >> 32);
                    }
                // the payload by chunks (lane j: chunk j), then the stamp
                auto send_a = [&](uint32_t* slot) {
#pragma unroll
                    for (int q = 0; q < MAX_MSG_A; q += 4)
                        if (q < MA && lane == q / 4)
                            __stcg(reinterpret_cast<uint4*>(slot + HEAD_A + q), make_uint4(m[q], m[q + 1], m[q + 2], m[q + 3]));
                };
                const size_t at = ((size_t)par * S + shard) * BA;
                if (!far) {
                    send_a(p.mbox_a + at);
                    __syncwarp();
                    if (lane == 0) stamp_release(p.mbox_a + at, seq);
                } else {
                    // into every launch's inbox; past the register zones the
                    // shard's row of zone sums too (complete: its blocks
                    // fenced their atomics before their cluster messages)
                    const long long* zmine = zrows ? zbuf + ((size_t)par * S + shard) * NZ : nullptr;
                    for (int g = 0; g < p.groups; ++g) {
                        send_a(peer_box(p, g, 0) + at);
                        if (zrows && g != p.group) {
                            long long* zto = reinterpret_cast<long long*>(peer_box(p, g, 2)) + ((size_t)par * S + shard) * NZ;
                            for (int z = lane; z < NZ; z += 32) __stcg(zto + z, __ldcg(zmine + z));
                        }
                    }
                    __syncwarp();
                    if (lane < p.groups) stamp_release_sys(peer_box(p, lane, 0) + at, seq);
                }
            }
            // every shard's message (lane q: shard q's), folded over the mesh
            const bool from = lane < S;
            uint32_t xa[MAX_MSG_A];
#pragma unroll
            for (int q = 0; q < MAX_MSG_A; ++q) xa[q] = 0;
            if (from) {
                const uint32_t* slot = p.mbox_a + ((size_t)par * S + lane) * BA;
                if (far) stamp_wait_sys(slot, seq);
                else stamp_wait(slot, seq);
#pragma unroll
                for (int q = 0; q < MAX_MSG_A; q += 4)
                    if (q < MA) {
                        const uint4 v = __ldcg(reinterpret_cast<const uint4*>(slot + HEAD_A + q));
                        xa[q] = v.x;
                        xa[q + 1] = v.y;
                        xa[q + 2] = v.z;
                        xa[q + 3] = v.w;
                    }
            }
            const long long n_feas = __reduce_add_sync(FULL, xa[0]);
            const long long n_zoned = __reduce_add_sync(FULL, xa[1]);
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
            long long zs[REG_ZONES];
#pragma unroll
            for (int zz = 0; zz < REG_ZONES; ++zz) {
                zs[zz] = 0;
                if (zz < NZR) {
                    zs[zz] = warp_sum64(join64(xa[11 + 2 * zz], xa[10 + 2 * zz]));
                    max_z = zs[zz] > max_z ? zs[zz] : max_z;
                }
            }
            if (lane == 0) {
                s_glob[0] = n_feas;
                s_glob[1] = n_zoned;
                s_glob[2] = max_n;
                s_glob[3] = aff_max;
                s_glob[4] = taint_max;
                s_glob[5] = ip_max;
                s_glob[6] = ip_min;
                s_glob[7] = max_z;
#pragma unroll
                for (int zz = 0; zz < REG_ZONES; ++zz) s_glob[8 + zz] = zs[zz];
            }
        }
        __syncthreads();
        const long long n_feas = s_glob[0];
        const bool have_zones = sg[R + 2] && s_glob[1] > 0;
        const long long max_n = s_glob[2], aff_max = s_glob[3], taint_max = s_glob[4];
        const long long ip_max = s_glob[5], ip_min = s_glob[6];
        long long max_z = s_glob[7];
#pragma unroll
        for (int zz = 0; zz < REG_ZONES; ++zz) zsum[zz] = s_glob[8 + zz];
        if (zrows) {
            // the mesh's zone totals from the shards' rows (past L1, which
            // does not see other blocks' atomics), one zone a thread; every
            // shard's rows are complete once its message is
            for (int z = tid; z < NZ; z += BT) {
                long long sum = 0;
                for (int q = 0; q < S; ++q) sum += __ldcg(zbuf + ((size_t)par * S + q) * NZ + z);
                ztot[z] = sum;
            }
            __syncthreads();
            long long mz = 0;
            for (int z = lane; z < NZ; z += 32) mz = ztot[z] > mz ? ztot[z] : mz;
            max_z = warp_max64(mz);
        }
        const long long rng = ip_max - ip_min;
        PHASE(4);  // (a) between clusters: the shard's message, the mesh's fold

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
                        if (zrows) {
                            if (z < NZ) zcnt = ztot[z];
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

        // ---- exchange (b), in the cluster: the block's best and its ties to rank 0 ----
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
                // (column round, warp) order, zero for warps below the best;
                // lane j sends chunks j, j + 32, ...
                const long long wb = lane < NW ? s_wb[par][lane] : I64_MIN;
                const long long bb = warp_max64(wb);
                const bool at = lane < NW && bb != I64_MIN && wb == bb;
                const unsigned atb = __ballot_sync(FULL, at);
                const unsigned ties = __reduce_add_sync(FULL, at ? static_cast<unsigned>(s_wt[par][lane]) : 0u);
                if (lane == 0) s_done[2 + par] = 0;  // for pod i+2
                for (int k = lane; k < MB / 4; k += 32) {
                    uint32_t v[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int slot = 4 * k + j, e = slot - 3;
                        if (slot < 3)
                            v[j] = slot == 0 ? static_cast<uint32_t>(bb)
                                 : slot == 1 ? static_cast<uint32_t>(bb >> 32) : ties;
                        else
                            v[j] = e < ENTS && ((atb >> (e % NW)) & 1) ? s_bal[par][e] : 0u;
                    }
                    send4(&s_inb[(par * (MB / 4) + k) * CS + rank], &s_xb[par], 0, v[0], v[1], v[2], v[3]);
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

        // ---- exchange (b) between clusters, and the pick ----
        if (warp == 0) {
            if (rank == 0) {
                mbar_wait_cluster(&s_xb[par], xpar);
                if (lane == 0) mbar_expect_tx(&s_xb[par], bytes_b);  // for pod i+2
                PHASE(7);  // (b) cluster wait
                // the shard's message: its best, its ties, each block's ties
                // at that best (lane q: block q), then the blocks' ballots
                const uint4* in = s_inb + par * (MB / 4) * CS;  // [chunk][CS]
                long long bq = I64_MIN;
                int tq = 0;
                if (lane < CS) {
                    const uint4 h = in[lane];
                    bq = join64(h.y, h.x);
                    tq = static_cast<int>(h.z);
                }
                const long long sbest = warp_max64(bq);
                if (bq != sbest) tq = 0;
                const unsigned sties = __reduce_add_sync(FULL, static_cast<unsigned>(tq));
                const uint32_t* ib = reinterpret_cast<const uint32_t*>(in);
                auto send_b = [&](uint32_t* slot) {
                    if (lane == 0) __stcg(reinterpret_cast<uint4*>(slot + 4), make_uint4(sties, 0u, 0u, 0u));
                    if (lane == 1)
                        __stcg(reinterpret_cast<unsigned long long*>(slot + 2), static_cast<unsigned long long>(sbest));
                    if (lane < CS) __stcg(slot + HEAD_B + lane, static_cast<uint32_t>(tq));
                    for (int e = lane; e < CS * ENTS; e += 32) {
                        const int q = e / ENTS, wd = 3 + e - q * ENTS;  // block q's word wd
                        __stcg(slot + HEAD_B + CS + e, ib[((wd >> 2) * CS + q) * 4 + (wd & 3)]);
                    }
                };
                const size_t at = ((size_t)par * S + shard) * BB;
                if (!far) {
                    send_b(p.mbox_b + at);
                    __syncwarp();
                    if (lane == 0) stamp_release(p.mbox_b + at, seq);
                } else {
                    for (int g = 0; g < p.groups; ++g) send_b(peer_box(p, g, 1) + at);
                    __syncwarp();
                    if (lane < p.groups) stamp_release_sys(peer_box(p, lane, 1) + at, seq);
                }
            }
            // every shard's best and ties (lane q: shard q's) and, in the
            // same round trip, each block's tie count in every shard (lane
            // b: block b's; the warp barrier orders these loads after the
            // stamps' acquires); the (rr % ties)-th tie names the shard,
            // its blocks' counts the block, that block's ballots the column
            if (lane < S) {
                if (far) stamp_wait_sys(p.mbox_b + ((size_t)par * S + lane) * BB, seq);
                else stamp_wait(p.mbox_b + ((size_t)par * S + lane) * BB, seq);
            }
            __syncwarp();
            long long bq = I64_MIN;
            int tq = 0;
            if (lane < S) {
                const uint32_t* slot = p.mbox_b + ((size_t)par * S + lane) * BB;
                bq = static_cast<long long>(__ldcg(reinterpret_cast<const unsigned long long*>(slot + 2)));
                tq = static_cast<int>(__ldcg(slot + 4));
            }
            int cnt[MAX_SHARDS];
#pragma unroll
            for (int q = 0; q < MAX_SHARDS; ++q)
                cnt[q] = q < S && lane < CS ? static_cast<int>(__ldcg(p.mbox_b + ((size_t)par * S + q) * BB + HEAD_B + lane)) : 0;
            int ch = -1;
            if (s_glob[0] > 0) {
                const long long top = warp_max64(bq);
                if (bq != top) tq = 0;
                const int incl = warp_incl_scan(tq);
                const int all = __shfl_sync(FULL, incl, 31);
                const int idx = static_cast<int>(rr % static_cast<uint32_t>(all));
                const unsigned hit = __ballot_sync(FULL, tq > 0 && idx >= incl - tq && idx < incl);
                const int os = __ffs(hit) - 1;
                int k = idx - __shfl_sync(FULL, incl - tq, os);
                const uint32_t* oslot = p.mbox_b + ((size_t)par * S + os) * BB;
                int tb = 0;
#pragma unroll
                for (int q = 0; q < MAX_SHARDS; ++q)
                    if (q == os) tb = cnt[q];
                const int incl_b = warp_incl_scan(tb);
                const unsigned hit_b = __ballot_sync(FULL, tb > 0 && k >= incl_b - tb && k < incl_b);
                const int ob = __ffs(hit_b) - 1;
                k -= __shfl_sync(FULL, incl_b - tb, ob);
                // rank k among the owner block's ballots, 32 at a time (lane j: ballot j)
                const uint32_t* obal = oslot + HEAD_B + CS + ob * ENTS;
                int node = -1;
                for (int e0 = 0; e0 < ENTS && node < 0; e0 += 32) {
                    const int e = e0 + lane;
                    const unsigned bal = e < ENTS ? __ldcg(obal + e) : 0u;
                    const int n = __popc(bal);
                    const int in_ = warp_incl_scan(n);
                    const unsigned got = __ballot_sync(FULL, k >= in_ - n && k < in_);
                    if (got) {
                        const int src = __ffs(got) - 1;
                        int pos = 0;
                        if (lane == src) pos = (e / NW) * BT + (e % NW) * 32 + nth_set_bit(bal, k - (in_ - n));
                        node = __shfl_sync(FULL, pos, src);
                    } else {
                        k -= __shfl_sync(FULL, in_, 31);
                    }
                }
                ch = os * NL + ob * L + node;
            }
            if (lane == 0) s_ch = ch;
        }
        __syncthreads();
        const int ch = s_ch;
        if (n_feas >= 2) ++rr;
        if (blockIdx.x == 0 && tid == 0) p.chosen[i] = ch;
        PHASE(8);  // (b) between clusters, the pick

        // ---- commit: each block writes only the columns it owns ----
        if (ch >= 0) {
            const int os = ch / NL, lcs = ch - os * NL;  // the chosen node's shard and its column there
            const int owner = lcs / L, lcc = lcs - owner * L;
            if (os == shard && owner == rank) {
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
            // the chosen node's domains, from its shard's global rows (static)
            const int64_t* own = p.shards + (size_t)os * NSHARD_PLANES;
            const int32_t* o_domain = reinterpret_cast<const int32_t*>(own[S_NODE_DOMAIN]);
            const int32_t* o_valid = reinterpret_cast<const int32_t*>(own[S_DOM_VALID]);
            for (int a = 0; a < tcount; ++a) {
                const int32_t* te = terms + a * TERM_FIELDS;
                const int m = te[1], ow = te[4];
                if (!m && !ow) continue;
                const int t = te[0];
                const int valid = o_valid[(size_t)t * NS + lcs], d = o_domain[(size_t)t * NS + lcs];
                if (valid) {
#pragma unroll
                    for (int c = 0; c < CPT; ++c) {
                        const int lc = c * BT + tid;
                        if (lc < L && dom_valid(t, lc) && node_domain(t, lc) == d) {
                            dm(t, lc) += m;
                            downer(t, lc) += ow;
                        }
                    }
                }
                if (tid == 0) s_total[t] += m;
            }
        }
        if (zrows && rank == 0) {
            // every block has folded this pod's rows (exchange (b) shows
            // it): clear the shard's for pod i+2, before the next message
            for (int z = tid; z < NZ; z += BT) zrow[z] = 0;
            __threadfence();
        }
        __syncthreads();
        PHASE(9);  // commit
    }
#ifdef MESH_SCAN_PHASES
    if (clocked)
        for (int k = 0; k < NPHASES; ++k) g_phases[k] = phase_acc[k];
#endif
    // the state planes placed in shared memory (req .. spread in the
    // planner's order), this block's columns, back to their global rows;
    // the pod loop ended on a block barrier
    for (int k = P_REQ; k <= P_SPREAD; ++k) {
        if (p.off[k] < 0) continue;
        const int rows = plane_rows(p, k);
        unsigned char* dst = static_cast<unsigned char*>(const_cast<void*>(s_pl[shard_plane(k)]));
        const unsigned char* src = smem + p.off[k];
        for (int e = tid; e < rows * L; e += BT) {
            const int row = e / L, col = e - row * L;
            if (k == P_VOLF) dst[(size_t)row * NS + base + col] = src[e];
            else reinterpret_cast<int32_t*>(dst)[(size_t)row * NS + base + col] =
                     reinterpret_cast<const int32_t*>(src)[e];
        }
    }
    if (blockIdx.x == 0) {  // every block's copy of total_match is the same
        for (int t = tid; t < T; t += BT) p.total[t] = s_total[t];
        if (tid == 0) {
            *p.rr = static_cast<int32_t>(rr);
            *p.cursor += 1;
            *p.epoch = static_cast<int32_t>(epoch);
        }
    }
    // no block leaves while another may still send to it
    cluster_arrive();
    cluster_wait();
}

// 0 when the parameters fit the kernel, else -1
int check(const MeshParams& p) {
    const int nw = p.threads / 32;
    const bool zrows = p.num_zones > REG_ZONES;
    const int msg_a = zrows ? 12 : (10 + 2 * p.num_zones + 3) / 4 * 4;
    if (p.shards_n < 1 || p.shards_n > MAX_SHARDS || p.cs < 1 || p.cs > MAX_CLUSTER ||
        p.threads < 32 || p.threads > MAX_THREADS || p.threads % 32 || p.cols < 16 || p.cols % 16 ||
        p.ns != p.cs * p.cols || p.n_local < 1 || p.cs * p.cols < p.n_local ||
        p.cols > p.threads * p.cpt || nw * p.cpt > MAX_CPT * MAX_WARPS ||
        p.r < 2 || p.r > MAX_R || p.t < 0 || p.t > MAX_TERMS || p.w > MAX_SLOTS || p.k > MAX_KINDS ||
        p.sw % 4 || p.sws % 4 || p.sws > p.sw || p.sws < p.r + 4 + TERM_FIELDS * p.t ||
        p.g4 % 4 || p.w4 % 4 || p.w4 < p.w || p.g4 < p.g || p.num_zones < 0 || p.p_real < 0 ||
        p.msg_a != msg_a || p.msg_b % 4 || p.msg_b < 3 + p.cpt * nw || p.box_a != HEAD_A + p.msg_a ||
        p.box_b % 4 || p.box_b < HEAD_B + p.cs + p.cs * p.cpt * nw || (zrows && p.zbuf == nullptr) ||
        (p.zone_off >= 0 && (!zrows || p.zone_off % 16 || p.zone_off + 8 * p.num_zones > p.smem_bytes)) ||
        p.stop == nullptr || p.rr == nullptr || p.cursor == nullptr || p.epoch == nullptr ||
        p.groups < 1 || p.groups > p.shards_n || p.group < 0 || p.group >= p.groups ||
        p.shard_lo < 0 || p.shards_here < 1 || p.shard_lo + p.shards_here > p.shards_n ||
        p.resident < p.shards_here || p.resident > p.shards_n ||
        (p.groups == 1 && p.shards_here != p.shards_n) || (p.groups > 1 && p.peers == nullptr))
        return -1;
    return 0;
}

// The kernel of `cpt` columns a thread, set for `smem` bytes of dynamic
// shared memory and clusters of any size up to 16; -3 when the static and
// dynamic shared memory together exceed what a block may have.
template <int CPT, bool FAR>
int configure(int smem, const void** kernel) {
    auto k = mesh_scan_kernel<CPT, FAR>;
    cudaFuncAttributes fa = {};
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (static_cast<int>(fa.sharedSizeBytes) + smem > optin) return -3;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    *kernel = (const void*)k;
    return static_cast<int>(err);
}

template <bool FAR>
int configure_far(int cpt, int smem, const void** kernel) {
    switch (cpt) {
        case 1: return configure<1, FAR>(smem, kernel);
        case 2: return configure<2, FAR>(smem, kernel);
        case 4: return configure<4, FAR>(smem, kernel);
        case 8: return configure<8, FAR>(smem, kernel);
        case 16: return configure<16, FAR>(smem, kernel);
        default: return -2;
    }
}

// the build for `cpt` columns a thread, in several launches or in one
int configure_cpt(int cpt, bool far, int smem, const void** kernel) {
    return far ? configure_far<true>(cpt, smem, kernel) : configure_far<false>(cpt, smem, kernel);
}

// How many clusters of `cs` blocks of this shape the card holds at once.
int max_clusters(const void* kernel, int cs, int threads, int smem, int* out) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

}  // namespace

#ifdef MESH_SCAN_PHASES
extern "C" int mesh_scan_read_phases(unsigned long long* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)));
}
#endif

// 0 on a launch; -1 parameters the kernel does not take, -2 a columns-a-
// thread it is not built for, -3 too much shared memory, -4 a grid of
// clusters the card cannot hold at once; else the CUDA error of the
// occupancy query or of the launch (a cooperative cluster launch the
// runtime refuses among them)
extern "C" int mesh_scan_launch(const MeshParams* params, void* stream) {
    const MeshParams& p = *params;
    if (check(p) != 0) return -1;
    const void* kernel = nullptr;
    int err = configure_cpt(p.cpt, p.groups > 1, p.smem_bytes, &kernel);
    int clusters = 0;
    if (err == 0) err = max_clusters(kernel, p.cs, p.threads, p.smem_bytes, &clusters);
    if (err != 0) return err;
    if (clusters < p.resident) return -4;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.shards_here * p.cs, 1, 1);
    cfg.blockDim = dim3(p.threads, 1, 1);
    cfg.dynamicSmemBytes = p.smem_bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    void* args[] = {const_cast<MeshParams*>(params)};
    const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, args);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// How many clusters of a plan's shape (cs blocks of `threads` threads,
// `cpt` columns a thread, `smem_bytes` of dynamic shared memory) the card
// holds at once, without a launch; the planner asks it for each cluster
// size it weighs.
extern "C" int mesh_scan_clusters(int cs, int threads, int cpt, int smem_bytes, int* out) {
    if (cs < 1 || cs > MAX_CLUSTER || threads < 32 || threads > MAX_THREADS || threads % 32) return -1;
    const void* kernel = nullptr;
    const int err = configure_cpt(cpt, false, smem_bytes, &kernel);
    if (err != 0) return err;
    return max_clusters(kernel, cs, threads, smem_bytes, out);
}

// The kernel a plan of `cpt` columns a thread launches, in several launches
// (`far`: every one of them launches this one) or in one: its static shared
// memory, registers a thread and local memory (spills) a thread, as the
// card reports them.
extern "C" int mesh_scan_attrs(int cpt, int far, int smem_bytes, int* attrs) {
    const void* kernel = nullptr;
    int err = configure_cpt(cpt, far != 0, smem_bytes, &kernel);
    if (err != 0) return err;
    cudaFuncAttributes fa = {};
    err = static_cast<int>(cudaFuncGetAttributes(&fa, kernel));
    attrs[0] = static_cast<int>(fa.sharedSizeBytes);
    attrs[1] = fa.numRegs;
    attrs[2] = static_cast<int>(fa.localSizeBytes);
    return err;
}

// Peer access from card `dev` to card `peer`, for a mesh whose launches are
// on both (the pushes into the other card's inboxes, the owner shard's
// domain rows, the refresh's count word): 0 once enabled (or already),
// -5 where the pair has no peer access (the host raises: nothing stages the
// messages through the host instead), else the CUDA error.
extern "C" int mesh_scan_enable_peer(int dev, int peer) {
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!can) return -5;
    int prev = 0;
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
    if (err == cudaSuccess) {
        err = cudaDeviceEnablePeerAccess(peer, 0);
        if (err == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();
            err = cudaSuccess;
        }
        cudaSetDevice(prev);
    }
    return static_cast<int>(err);
}

// A stream of its own on card `dev` for a launch of a grouped mesh, never
// one that PyTorch hands out (two launches of one mesh on one stream would
// wait on each other forever): 0 and the stream in *out, else the error.
extern "C" int mesh_scan_stream(int dev, void** out) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
    if (err == cudaSuccess) {
        cudaStream_t s = nullptr;
        err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
        *out = s;
        cudaSetDevice(prev);
    }
    return static_cast<int>(err);
}
