// The frontier loop's chunk-end refresh for Hopper (sm_90a): one pass over
// the [G, ns] monotone feasibility plane after each chunk of the fused scan.
//
// Replaces the JAX package's device program of the same step: the tail of
// the device-resident wave loop's body (kubernetes_tpu/ops/batch_kernel.py
// ::_make_loop_run, the still_ok refresh and the alive count) with
// monotone_plane_device. Its plain version is
// kubernetes_tpu_torch/ops/scan_ref.py::refresh (monotone_plane + alive_of).
//
// What it computes, for every node column j, after a chunk of the scan:
//   still_ok[g, j] &= static_ok[g, j] && exists[j] && pods_ok[j] && fit[g, j]
//                     && no host port of g taken on j
//                     && no own required-anti term of g with dm[t, j] > 0
//                     && no required-anti term matching g with downer[t, j] > 0
//   alive[j] = exists[j] && any_g still_ok[g, j]
//   n_alive = sum_j alive[j];  stop = n_alive <= thresh  (thresh -1: never)
// The state planes are the fused scan's own written-back planes in its
// packed layout (fused_scan.py pack), the terms and ports come from the
// signature rows, so the refresh reads what the next chunk will read.
//
// The loop is enqueued whole, chunk and refresh launches in turn, without a
// host sync (ops/frontier.py): each launch first reads the stop flag and
// returns if an earlier refresh has set it, so everything behind a wanted
// compaction is a no-op until the host re-enters. That early return is the
// launch floor: what a launch costs the card when it does nothing.
//
// What bounds it on this card: bytes (still_ok read and written, static_ok
// as bytes, the column state rows and the rows the signatures name, each
// once: 0.76 MB at 32 signatures x 5120 columns, 0.23 us at 3.35 TB/s;
// chip_smoke.py refresh_bound), and all of them sit in L2, just written by
// the chunk. What holds a
// refresh back is latency: the launch itself (the floor: a launch that
// returns at once costs ~2 us) and every round trip to L2 on a block's
// chain. The first design made each (signature, column) cell a chain of
// dependent global loads (the signature's words, then the state words they
// name), and its cross-block count three more round trips. This design:
// - A host planner (frontier_refresh.py plan) owns the layout: a grid of
//   column tiles (blockIdx.x, `cols` columns) by signature groups
//   (blockIdx.y, `gs` signatures), one group wherever a block can hold
//   every signature, at least two blocks an SM at the main width, and
//   every shared-memory region's offset. The kernel only checks that what
//   it was given fits, and the launch returns non-zero otherwise.
// - Each signature row is reduced once a segment, on the card
//   (frontier_refresh.py signature_table), to what a cell walks: its
//   requests and the ascending ids of the rows it names (dm rows of its own
//   required-anti terms, downer rows of the required-anti terms that match
//   it, its set host-port slots). Reducing in every block, from the fused
//   scan's full signature rows, made those rows most of what a block staged
//   and raised the launch floor from 2.2 to 5.2 us (PERF.md).
// - A block stages its tile at once, 16 bytes a thread with cp.async: its
//   group's table rows (contiguous; through L1, since every tile's block on
//   an SM reads the same rows), the column state rows (req, alloc, cnt,
//   alloc_pods, exists; each a contiguous run of the packed [rows, ns]
//   layout) and, where the planner fits them in one stage (`kcap` >= the
//   dm, downer and host-port rows there are), every row a signature can
//   name. A tile row is only 64-128 bytes. One cp.async.bulk a row on an
//   mbarrier cost about 40 ns of an SM's copy engine each, and one bulk
//   copy of the table a block sent every block to the same L2 lines: each
//   raised the launch floor (to 3.7-6.6 us at 5120-20 224 columns,
//   PERF.md). Spread over the block's threads, the copies cost one round
//   trip. Every thread meanwhile loads its cells' still_ok and static_ok
//   (one 32-bit word each; static_ok as bytes, a copy made once a segment,
//   a quarter of the fused scan's int32 plane) and the stop flag. A cell's
//   chain then walks only its signature's requests and named rows, in
//   shared memory. Where the rows do not fit one stage (wide port rows),
//   the block numbers the rows its signatures name and copies them next,
//   `kcap` rows at a time.
// - A thread owns 4 neighbouring columns of one signature row (CPT), so
//   still_ok and static_ok move as 32-bit words and every staged row as
//   128-bit words.
// - The count takes one atomic a tile: a word holds the tiles done in its
//   low TILE_BITS bits and the alive count above them, so the last tile
//   reads the total from its own atomic and publishes CTL_ALIVE and
//   CTL_STOP. Under the node-axis mesh (parallel/mesh.py) each shard's
//   slice is refreshed by a launch of its own, in stream order, and all add
//   into the one word: the last tile of the last launch (tiles_total) sees
//   the whole width's count. The earlier launches have finished before it
//   starts, so every block of every shard read the stop flag the previous
//   chunk's refresh left. Where signatures split into several groups, each block ORs
//   its columns' bits into a scratch word per 32 columns and the last
//   block of a tile (a ticket per tile) reads and clears them first. The
//   scratch is zero between launches: no second launch, no memset.
// - The stop flag is read with the first loads; a block that finds it
//   raised waits for its copies and returns before writing anything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPT = 4;           // columns a thread
constexpr int MAX_COLS = 256;    // columns a tile, at most (s_words)
constexpr int MAX_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use on the card
constexpr int TILE_BITS = 14;       // the count word: tiles done below, the alive count above
constexpr unsigned FULL = 0xffffffffu;
// control words, as fused_scan.py's CTL_* constants
constexpr int CTL_STOP = 1, CTL_ALIVE = 2, CTL_ACC = 3;

}  // namespace

extern "C" {

struct RefreshParams {
    // the scan's state after the chunk (packed layout, [rows, ns])
    const int32_t* req;         // [R, ns]
    const int32_t* cnt;         // [ns]
    const int32_t* ports;       // [PV, ns]
    const int32_t* dm;          // [T, ns]
    const int32_t* downer;      // [T, ns]
    // statics
    const int32_t* alloc;       // [R, ns]
    const int32_t* alloc_pods;  // [ns]
    const int32_t* exists;      // [ns]
    const uint8_t* static_ok;   // [G, ns]: the fused scan's static_ok as bytes
    const int32_t* table;       // [G, tw]: the signature rows reduced: request [R], n, n row ids ascending
    // the plane, updated in place, and the outputs
    uint8_t* still_ok;          // [G, ns]
    uint8_t* alive;             // [ns]
    int32_t* ctl;               // the loop's control words
    int32_t* scratch;           // zero between launches: alive bits of each 32 columns, then a ticket a tile
    int32_t ns, g, r, t, pv, tw, use_terms, use_ports, thresh;
    // the plan (frontier_refresh.py plan): tiles of `cols` columns x groups of `gs` signatures;
    // tiles_total: the tiles of every launch that adds into the count word (a
    // mesh's shards refresh their slices in one launch each, tiles x shards)
    int32_t cols, gs, tiles, tiles_total, groups, threads, kcap, smem_bytes;
    // byte offsets in dynamic shared memory: column state rows, table rows,
    // named rows (kcap), the slot of each row id, the block's alive columns
    int32_t off_state, off_table, off_rows, off_slot, off_col;
};

}  // extern "C"

namespace {

// ---- cp.async ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, per thread (cp.async): through
// L2 only (cg), or kept in L1 too (ca) for what every block of an SM reads;
// the thread's copies complete at cp.async.wait_all
__device__ __forceinline__ void copy16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy16_l1(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy16_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ int4 ld4(const int32_t* p) { return *reinterpret_cast<const int4*>(p); }

// column state row k of the tile: req[0, R), alloc[R, 2R), cnt, alloc_pods, exists
__device__ __forceinline__ const int32_t* state_row(const RefreshParams& p, int k) {
    const size_t NS = p.ns;
    if (k < p.r) return p.req + k * NS;
    if (k < 2 * p.r) return p.alloc + (k - p.r) * NS;
    return k == 2 * p.r ? p.cnt : k == 2 * p.r + 1 ? p.alloc_pods : p.exists;
}

// named row rid: dm[0, T), downer[T, 2T), host-port slots [2T, 2T + PV)
__device__ __forceinline__ const int32_t* named_row(const RefreshParams& p, int T, int rid) {
    const size_t NS = p.ns;
    if (rid < T) return p.dm + rid * NS;
    if (rid < 2 * T) return p.downer + (rid - T) * NS;
    return p.ports + (rid - 2 * T) * NS;
}

__global__ void __launch_bounds__(MAX_THREADS) frontier_refresh_kernel(const RefreshParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned s_words[MAX_COLS / 32];
    __shared__ int s_nk, s_last;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
    const int C = p.cols, NS = p.ns, R = p.r, TW = p.tw;
    const int T = p.use_terms ? p.t : 0, PV = p.use_ports ? p.pv : 0;
    const int NR = 2 * T + PV;  // the row ids a signature can name
    // every such row fits one stage: staged with the tile, a row's slot is its id
    const bool all = p.kcap >= NR;
    const int base = blockIdx.x * C, len = min(C, NS - base);  // len: a multiple of 16
    const int q16 = len / 4;  // 16-byte pieces of a row of the tile
    const int g0 = blockIdx.y * p.gs, gn = min(p.gs, p.g - g0);

    int32_t* s_state = reinterpret_cast<int32_t*>(smem + p.off_state);  // [2R + 3][C]
    int32_t* s_tab = reinterpret_cast<int32_t*>(smem + p.off_table);    // [gs][TW]
    int32_t* s_rows = reinterpret_cast<int32_t*>(smem + p.off_rows);    // [kcap][C]
    int32_t* s_slot = reinterpret_cast<int32_t*>(smem + p.off_slot);    // [NR]: row id -> slot
    int32_t* s_rid = s_slot + NR;                                       // [NR]: slot -> row id
    int32_t* s_col = reinterpret_cast<int32_t*>(smem + p.off_col);      // [C]

    // ---- stage the tile at once, 16 bytes a thread: the group's table rows
    // (contiguous; every tile's blocks read them, so through L1), the column
    // state rows and (every) named row ----
    const int nstate = 2 * R + 3, nrows = all ? NR : 0;
    for (int i = tid; i < gn * TW / 4; i += blockDim.x)
        copy16_l1(s_tab + 4 * i, p.table + (size_t)g0 * TW + 4 * i);
    for (int i = tid; i < (nstate + nrows) * q16; i += blockDim.x) {
        const int k = i / q16, c = (i - k * q16) * 4;
        if (k < nstate)
            copy16(s_state + k * C + c, state_row(p, k) + base + c);
        else
            copy16(s_rows + (k - nstate) * C + c, named_row(p, T, k - nstate) + base + c);
    }
    // meanwhile: the stop flag, and this thread's cells (signature gl of the
    // block, columns c0..c0+3) from global memory
    const int stop = p.ctl[CTL_STOP];
    const int qpr = C / CPT;
    const int gl = tid / qpr, c0 = (tid - gl * qpr) * CPT;
    const bool mine = gl < gn && c0 < len;
    const size_t cell = (size_t)(g0 + gl) * NS + base + c0;
    uint32_t still4 = 0, ok4 = 0;
    if (mine) {
        still4 = *reinterpret_cast<const uint32_t*>(p.still_ok + cell);
        ok4 = __ldg(reinterpret_cast<const uint32_t*>(p.static_ok + cell));
    }
    const uint32_t live4 = still4 & ok4;  // both 0/1 bytes
    if (!all)
        for (int i = tid; i < NR; i += blockDim.x) s_slot[i] = 0;
    for (int i = tid; i < C; i += blockDim.x) s_col[i] = 0;
    copy16_wait();
    __syncthreads();
    // a compaction is already wanted: the host re-enters before this runs
    // again (the flag is written only by the last tile of a launch, after
    // every block of that launch has read it); nothing is written
    if (stop != 0) return;

    // the column takes a pod at all: exists and a pod slot left (in place of exists)
    int32_t* s_base = s_state + (2 * R + 2) * C;
    for (int c = tid; c < len; c += blockDim.x)
        s_base[c] = s_base[c] != 0 && s_state[2 * R * C + c] + 1 <= s_state[(2 * R + 1) * C + c];

    // the named rows of slots [k0, k0 + kcap) (rows past one stage), every thread's
    // copies complete at the barrier after
    int nk = NR;
    auto stage = [&](int k0) {
        const int k1 = min(nk, k0 + p.kcap);
        for (int i = tid; i < (k1 - k0) * q16; i += blockDim.x) {
            const int k = i / q16, c = (i - k * q16) * 4;
            copy16(s_rows + k * C + c, named_row(p, T, s_rid[k0 + k]) + base + c);
        }
        copy16_wait();
    };
    if (!all) {
        // the rows the block's signatures name, a slot each in row order,
        // and each signature's row ids turned into slots (still ascending)
        for (int i = tid; i < gn * NR; i += blockDim.x) {
            const int32_t* tb = s_tab + (i / NR) * TW;
            const int k = i % NR;
            if (k < tb[R]) s_slot[tb[R + 1 + k]] = 1;
        }
        __syncthreads();
        if (warp == 0) {
            int run = 0;
            for (int i0 = 0; i0 < NR; i0 += 32) {
                const int i = i0 + lane;
                const bool f = i < NR && s_slot[i] != 0;
                const unsigned b = __ballot_sync(FULL, f);
                const int slot = run + __popc(b & ((1u << lane) - 1));
                if (i < NR) s_slot[i] = f ? slot : -1;
                if (f) s_rid[slot] = i;
                run += __popc(b);
            }
            if (lane == 0) s_nk = run;
        }
        __syncthreads();
        nk = s_nk;
        for (int i = tid; i < gn * NR; i += blockDim.x) {
            int32_t* tb = s_tab + (i / NR) * TW;
            const int k = i % NR;
            if (k < tb[R]) tb[R + 1 + k] = s_slot[tb[R + 1 + k]];
        }
        if (nk > 0) stage(0);
    }
    __syncthreads();

    // ---- the cells: static_ok, the column, the resources, the named rows ----
    const int4 b4 = ld4(s_base + c0);
    bool m0 = mine && (live4 & 0xffu) && b4.x;
    bool m1 = mine && (live4 & 0xff00u) && b4.y;
    bool m2 = mine && (live4 & 0xff0000u) && b4.z;
    bool m3 = mine && (live4 & 0xff000000u) && b4.w;
    const int32_t* tb = s_tab + (mine ? gl : 0) * TW;
    if (m0 || m1 || m2 || m3) {
        for (int r = 0; r < R; ++r) {
            const long long need = tb[r];
            if (need <= 0) continue;  // requests nothing of r
            const int4 q = ld4(s_state + r * C + c0), a = ld4(s_state + (R + r) * C + c0);
            m0 = m0 && q.x + need <= a.x;
            m1 = m1 && q.y + need <= a.y;
            m2 = m2 && q.z + need <= a.z;
            m3 = m3 && q.w + need <= a.w;
        }
    }
    const int32_t* lst = tb + R + 1;  // this signature's named rows' slots, ascending
    const int nkill = mine ? tb[R] : 0;
    int cur = 0;
    for (int k0 = 0; k0 < nk; k0 += p.kcap) {
        if (k0 > 0) {  // the previous stage is read: its buffer takes the next
            __syncthreads();
            stage(k0);
            __syncthreads();
        }
        const int k1 = min(nk, k0 + p.kcap);
        for (; cur < nkill && lst[cur] < k1; ++cur) {
            const int4 v = ld4(s_rows + (lst[cur] - k0) * C + c0);
            m0 = m0 && v.x <= 0;
            m1 = m1 && v.y <= 0;
            m2 = m2 && v.z <= 0;
            m3 = m3 && v.w <= 0;
        }
    }
    if (mine) {
        const uint32_t now = (m0 ? 0x1u : 0u) | (m1 ? 0x100u : 0u) | (m2 ? 0x10000u : 0u)
                             | (m3 ? 0x1000000u : 0u);
        if (now != still4) *reinterpret_cast<uint32_t*>(p.still_ok + cell) = now;  // dead stays dead
        if (m0) s_col[c0] = 1;
        if (m1) s_col[c0 + 1] = 1;
        if (m2) s_col[c0 + 2] = 1;
        if (m3) s_col[c0 + 3] = 1;
    }
    __syncthreads();

    // ---- alive: the block's columns as bits, across the groups if several ----
    const int nw = (len + 31) >> 5;
    for (int w = warp; w < nw; w += nwarps) {
        const int c = (w << 5) + lane;
        const unsigned bits = __ballot_sync(FULL, c < len && s_col[c] != 0);
        if (lane == 0) {
            if (p.groups == 1) s_words[w] = bits;
            else if (bits) atomicOr(reinterpret_cast<unsigned*>(p.scratch) + base / 32 + w, bits);
        }
    }
    if (p.groups > 1) {
        // cols is a multiple of 32 here: the tile's words are its own
        unsigned* words = reinterpret_cast<unsigned*>(p.scratch) + base / 32;
        int32_t* tickets = p.scratch + (NS + 31) / 32;
        __threadfence();
        __syncthreads();
        if (tid == 0) s_last = atomicAdd(&tickets[blockIdx.x], 1) == p.groups - 1;
        __syncthreads();
        if (!s_last) return;  // another block of the tile finishes it
        __threadfence();
        for (int w = tid; w < nw; w += blockDim.x) s_words[w] = atomicExch(&words[w], 0u);
        if (tid == 0) tickets[blockIdx.x] = 0;
    }
    __syncthreads();
    // base includes exists: a column that does not exist has no live row
    for (int c = tid; c < len; c += blockDim.x) p.alive[base + c] = (s_words[c >> 5] >> (c & 31)) & 1u;
    if (tid == 0) {
        unsigned n = 0;
        for (int w = 0; w < nw; ++w) n += __popc(s_words[w]);
        // one atomic: this tile done, its count added; the last tile (of every
        // launch that shares the word) publishes the total and resets the
        // word for the next refresh
        const unsigned old = atomicAdd(reinterpret_cast<unsigned*>(&p.ctl[CTL_ACC]),
                                       (n << TILE_BITS) | 1u);
        if ((old & ((1u << TILE_BITS) - 1)) == static_cast<unsigned>(p.tiles_total - 1)) {
            const int n_alive = static_cast<int>((old >> TILE_BITS) + n);
            p.ctl[CTL_ALIVE] = n_alive;
            p.ctl[CTL_STOP] = n_alive <= p.thresh ? 1 : 0;
            p.ctl[CTL_ACC] = 0;
        }
    }
}

// the regions of dynamic shared memory, in order, each within smem_bytes
bool layout_fits(const RefreshParams& p) {
    const int T = p.use_terms ? p.t : 0, PV = p.use_ports ? p.pv : 0, NR = 2 * T + PV;
    const long long regions[5][2] = {
        {p.off_state, (2LL * p.r + 3) * p.cols * 4},
        {p.off_table, 4LL * p.gs * p.tw},
        {p.off_rows, 4LL * p.kcap * p.cols},
        {p.off_slot, 8LL * NR},
        {p.off_col, 4LL * p.cols},
    };
    long long end = 0;
    for (const auto& reg : regions) {
        if (reg[0] % 16 != 0 || reg[0] < end) return false;
        end = reg[0] + reg[1];
    }
    return end <= p.smem_bytes && p.smem_bytes <= SMEM_LIMIT && (NR == 0 || p.kcap >= 1);
}

}  // namespace

// 0 on a launch; -1 shapes the table row or the count word cannot hold,
// -2 a plan that does not cover the plane or that the block cannot take,
// -3 a shared-memory layout that does not fit; else the launch's CUDA error
extern "C" int frontier_refresh_launch(const RefreshParams* p, void* stream) {
    if (p->ns < 16 || p->ns % 16 != 0 || p->ns >= (1 << (32 - TILE_BITS)) || p->g < 1 || p->r < 1
        || p->t < 0 || p->pv < 0 || p->tw % 4 != 0
        || p->tw < p->r + 1 + (p->use_terms ? 2 * p->t : 0) + (p->use_ports ? p->pv : 0))
        return -1;
    if (p->cols < 16 || p->cols > MAX_COLS || p->cols % 16 != 0
        || (p->groups > 1 && p->cols % 32 != 0) || p->gs < 1
        || p->threads != p->gs * p->cols / CPT || p->threads % 32 != 0 || p->threads > MAX_THREADS
        || p->tiles != (p->ns + p->cols - 1) / p->cols || p->tiles_total < p->tiles
        || p->tiles_total >= (1 << TILE_BITS)
        || p->groups != (p->g + p->gs - 1) / p->gs || p->groups > 65535 || p->scratch == nullptr)
        return -2;
    if (!layout_fits(*p)) return -3;
    if (p->smem_bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            frontier_refresh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    frontier_refresh_kernel<<<dim3(p->tiles, p->groups), p->threads, p->smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(*p);
    return static_cast<int>(cudaGetLastError());
}
