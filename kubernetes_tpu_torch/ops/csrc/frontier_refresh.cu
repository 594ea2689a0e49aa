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
// compaction is a no-op until the host re-enters.
//
// What bounds it on this card: its bound is bytes (~5 G bytes a column,
// each read once, against a handful of integer compares a signature), but
// at the loop's widths (a few thousand columns) it is load latency: each
// (signature, column) cell is a short chain of dependent loads. So a block
// takes 32 columns (a warp's lanes, coalesced rows) and its 8 warps split
// the signatures among them, which puts ~8x more warps in flight than one
// thread a column (that first version took 57.7 us at 32 signatures x
// 5120 columns on an H100 80GB HBM3 at 700 W, PERF.md); the warps OR
// their columns' rows in shared memory. The count crosses blocks by one atomic add a block; the last
// block to finish (a ticket) publishes the count and the stop flag and
// resets the accumulators for the next refresh, so the reduction needs no
// second launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TERM_FIELDS = 9;  // the fused scan's signature-row term entry
constexpr int COLS = 32;        // columns a block: one a lane
constexpr int WARPS = 8;        // warps a block, each a share of the signatures
constexpr unsigned FULL = 0xffffffffu;
// control words, as fused_scan.py's CTL_* constants
constexpr int CTL_STOP = 1, CTL_ALIVE = 2, CTL_ACC = 3, CTL_DONE = 4;

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
    const int32_t* static_ok;   // [G, ns]
    const int32_t* sig;         // [G, sw]: request, nonzero, spread flag, term count, terms, ports
    // the plane, updated in place, and the outputs
    uint8_t* still_ok;          // [G, ns]
    uint8_t* alive;             // [ns]
    int32_t* ctl;               // the loop's control words
    int32_t ns, g, r, t, pv, sw, use_terms, use_ports, thresh;
};

}  // extern "C"

namespace {

__global__ void __launch_bounds__(COLS * WARPS) frontier_refresh_kernel(const RefreshParams p) {
    // a compaction is already wanted: the host re-enters before this runs
    // again (the flag is written only by the last block of a launch, after
    // every block of that launch has read it)
    if (p.ctl[CTL_STOP] != 0) return;
    __shared__ unsigned char s_any[WARPS][COLS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j = blockIdx.x * COLS + lane;
    const int R = p.r, NS = p.ns;
    const int port0 = R + 4 + TERM_FIELDS * p.t;
    bool any = false;
    if (j < NS) {
        const bool base = p.exists[j] != 0 && p.cnt[j] + 1 <= p.alloc_pods[j];
        for (int g = warp; g < p.g; g += WARPS) {
            uint8_t* so = p.still_ok + (size_t)g * NS + j;
            if (!*so) continue;  // dead for g: stays dead
            bool m = base && p.static_ok[(size_t)g * NS + j] != 0;
            const int32_t* sg = p.sig + (size_t)g * p.sw;
            for (int r = 0; r < R && m; ++r) {
                const int need = sg[r];
                if (need > 0) m = (long long)p.req[(size_t)r * NS + j] + need <= p.alloc[(size_t)r * NS + j];
            }
            if (p.use_ports)
                for (int q = 0; q < p.pv && m; ++q)
                    if (sg[port0 + q] && p.ports[(size_t)q * NS + j]) m = false;
            if (p.use_terms) {
                const int tcount = sg[R + 3];
                for (int a = 0; a < tcount && m; ++a) {
                    const int32_t* te = sg + R + 4 + a * TERM_FIELDS;
                    const size_t at = (size_t)te[0] * NS + j;
                    if (te[3] && p.dm[at] > 0) m = false;      // own required anti-affinity
                    if (te[7] && p.downer[at] > 0) m = false;  // a placed owner's, symmetric
                }
            }
            if (!m) *so = 0;
            any = any || m;
        }
    }
    s_any[warp][lane] = any;
    __syncthreads();
    if (warp != 0) return;
    bool alive = false;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) alive = alive || s_any[w][lane];
    // base includes exists: a column that does not exist has no live row
    if (j < NS) p.alive[j] = alive;
    const unsigned live = __ballot_sync(FULL, alive);
    if (lane == 0) {
        atomicAdd(&p.ctl[CTL_ACC], __popc(live));
        __threadfence();
        const int done = atomicAdd(&p.ctl[CTL_DONE], 1);
        if (done == static_cast<int>(gridDim.x) - 1) {
            // every block's count is in: publish, and reset for the next
            __threadfence();
            const int n_alive = atomicAdd(&p.ctl[CTL_ACC], 0);
            p.ctl[CTL_ALIVE] = n_alive;
            p.ctl[CTL_STOP] = n_alive <= p.thresh ? 1 : 0;
            p.ctl[CTL_ACC] = 0;
            p.ctl[CTL_DONE] = 0;
        }
    }
}

}  // namespace

extern "C" int frontier_refresh_launch(const RefreshParams* p, void* stream) {
    if (p->ns < 1 || p->g < 1 || p->r < 1 || p->sw < p->r + 4 + TERM_FIELDS * p->t + (p->use_ports ? p->pv : 0))
        return -1;
    const int blocks = (p->ns + COLS - 1) / COLS;
    frontier_refresh_kernel<<<blocks, COLS * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(*p);
    return static_cast<int>(cudaGetLastError());
}
