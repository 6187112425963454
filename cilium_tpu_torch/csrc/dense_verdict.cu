// Dense broadcast-compare policy verdict for Hopper (sm_90a).
//
// Replaces the TPU kernel cilium_tpu/ops/dense_verdict.py:
// _dense_tiled_kernel (launched by dense_verdict_pallas).  Same function:
// B packets against N flat policy entries, the 3-stage fallback of
// bpf/lib/policy.h __policy_can_access, giving a verdict per packet and
// per-entry packet/byte counter deltas at the entry that decided it.
//
//   stage 1  exact     (ep, identity, meta_exact) -> value (allow / proxy)
//   stage 2  L3-only   (ep, identity, meta_l3)    -> allow
//   stage 3  wildcard  (ep, 0,        meta_exact) -> value
//   else     drop (-1)
//
// Only entries of the packet's own endpoint can match, and the tables
// hold each endpoint's entries as one contiguous segment (the wrapper's
// dense_segments checks that and passes the offsets).  So the kernel
// groups the packets by endpoint and compares each group with its own
// segment only: B x N / E pairs instead of B x N.
//
// What bounds it: the integer compares of those segment pairs on the
// ALU pipe (64 lanes per SM; the SASS read by
// cilium_tpu_torch/sass_mix.py gives the instructions per pair), plus
// the grouping's bytes (packets read twice, a 16-byte record per packet
// written and read once, verdicts written once), which bound it only
// where segments are short.  The design, piece by piece:
//   - a counting sort on the card, with no host read before the verdict
//     launch.  histogram_kernel counts packets per endpoint in shared
//     memory, one global add per bin and block; scan_kernel turns the
//     counts into each group's first position and into one descriptor
//     per verdict block (group start, packet count, segment bounds);
//     scatter_kernel writes each packet as a 16-byte record (index,
//     identity, meta word, length) at its group's position.  Every
//     per-bin bump is warp-aggregated (__match_any_sync, one atomic from
//     the leader): a warp's 32 packets fall on a handful of endpoints.
//     Packets whose endpoint lies outside [0, E) drop here, uncounted;
//   - the verdict grid is sized from B and E alone, ceil(B / kPerBlock)
//     + E blocks; spare blocks find a zero count and return;
//   - a verdict block holds kPerThread packets of one endpoint per
//     thread in registers, so one broadcast LDS.128 of an entry feeds
//     kPerThread pairs, and the endpoint compare is gone: every entry
//     of the segment has the block's endpoint.  The miss test takes
//     three compares a packet; two packets a thread ran fastest on the
//     H100 (cilium_tpu_torch/sweep_dense.py times 1, 2, 4 and 8: more
//     packets spill predicates and the compares stop folding);
//   - the segment streams through two shared-memory tiles filled by
//     cp.async (16 bytes a thread): tile k+1 lands while tile k is
//     compared.  32 KB in all, under the 48 KB of static shared memory;
//   - per-stage running sums (hit, value, index + 1) stay in registers
//     and select the single match per stage, as in the Pallas kernel
//     (keys are unique per endpoint).  Hits are rare beside the
//     compares, so the accumulate sits behind a branch;
//   - the deciding entry's counters are bumped with warp-aggregated
//     atomics: lanes with the same entry elect a leader, which adds the
//     group's packet count and summed length (__reduce_add_sync).
//     Counters are int32 adds, the bits of the reference's uint32 sums.
// Meta words are packed in uint32, so a port >= 32768 lands in the sign
// bit without signed-shift UB.  Any B, N and E is taken.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kDrop = -1;
constexpr unsigned kFull = 0xFFFFFFFFu;

// grouping kernels: one block sorts kChunk packets
constexpr int kGroupThreads = 1024;
constexpr int kGroupPerThread = 4;
constexpr int kChunk = kGroupThreads * kGroupPerThread;
// up to this many endpoints the bins of a block sit in shared memory;
// above it, bumps go to global memory (warp-aggregated all the same)
constexpr int kSharedBins = 4096;

// verdict kernel
constexpr int kThreads = 256;
// packets a thread compares with each entry it loads (PACKETS_PER_THREAD
// in ops/dense_verdict.py)
constexpr int kPerThread = 2;
constexpr int kPerBlock = kThreads * kPerThread;
constexpr int kTile = 1024;  // entries per shared-memory tile, 16 KB

__device__ __forceinline__ uint32_t pack_meta(uint32_t dport,
                                              uint32_t proto,
                                              uint32_t dir) {
  return ((dport & 0xFFFFu) << 16) | ((proto & 0xFFu) << 8) |
         ((dir & 1u) << 1) | 1u;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Adds one to bins[key] for every lane of the warp whose key is >= 0,
// with one atomic per distinct key, and returns the bin's old value plus
// the lane's rank among the lanes of its key.  All 32 lanes call it.
__device__ __forceinline__ int warp_bump(int32_t* bins, int key) {
  const unsigned peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  const int rank = __popc(peers & ((1u << lane_id()) - 1u));
  int base = 0;
  if (key >= 0 && lane_id() == leader) {
    base = atomicAdd(&bins[key], __popc(peers));
  }
  return __shfl_sync(peers, base, leader) + rank;
}

// Packet p's endpoint if it lies in [0, n_ep), else -1.
__device__ __forceinline__ int valid_ep(const int32_t* pkt_ep, int p, int b,
                                        int n_ep) {
  if (p >= b) return -1;
  const int ep = pkt_ep[p];
  return ep >= 0 && ep < n_ep ? ep : -1;
}

__global__ void __launch_bounds__(kGroupThreads)
histogram_kernel(const int32_t* __restrict__ pkt_ep, int b, int n_ep,
                 int32_t* __restrict__ counts,
                 int32_t* __restrict__ verdict) {
  extern __shared__ int32_t bins[];
  const bool shared = n_ep <= kSharedBins;
  if (shared) {
    for (int i = threadIdx.x; i < n_ep; i += kGroupThreads) bins[i] = 0;
  }
  __syncthreads();
  for (int k = 0; k < kGroupPerThread; ++k) {
    const int p = blockIdx.x * kChunk + k * kGroupThreads + threadIdx.x;
    const int ep = valid_ep(pkt_ep, p, b, n_ep);
    if (p < b && ep < 0) verdict[p] = kDrop;
    warp_bump(shared ? bins : counts, ep);
  }
  __syncthreads();
  if (shared) {
    for (int i = threadIdx.x; i < n_ep; i += kGroupThreads) {
      if (bins[i]) atomicAdd(&counts[i], bins[i]);
    }
  }
}

// Exclusive scan of v over the 1024 threads of the block; *total gets
// the sum.  Every thread calls it.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane_id() >= o) x += y;
  }
  if (lane_id() == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane_id()];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane_id() >= o) s += y;
    }
    warp_sums[lane_id()] = s;
  }
  __syncthreads();
  const int out = x - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[31];
  __syncthreads();
  return out;
}

// One block of 1024 threads.  cursor[e] = first sorted position of
// endpoint e's packets; first_block[e] = its first verdict block; then
// desc[k] = (first sorted position, packet count, segment begin, segment
// end) of verdict block k, count 0 for the spare blocks.
__global__ void __launch_bounds__(1024)
scan_kernel(const int32_t* __restrict__ counts,
            const int32_t* __restrict__ offsets, int n_ep, int grid,
            int32_t* __restrict__ cursor, int32_t* __restrict__ first_block,
            int4* __restrict__ desc) {
  int pos = 0, blocks = 0;
  for (int lo = 0; lo < n_ep; lo += 1024) {
    const int e = lo + threadIdx.x;
    const int c = e < n_ep ? counts[e] : 0;
    int pos_total, blocks_total;
    const int at = block_scan(c, &pos_total);
    const int first = block_scan((c + kPerBlock - 1) / kPerBlock,
                                 &blocks_total);
    if (e < n_ep) {
      cursor[e] = pos + at;
      first_block[e] = blocks + first;
    }
    pos += pos_total;
    blocks += blocks_total;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < grid; k += 1024) {
    if (k >= blocks) {
      desc[k] = make_int4(0, 0, 0, 0);
      continue;
    }
    // the last endpoint whose first block is <= k owns block k
    int lo = 0, hi = n_ep;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (first_block[mid] <= k) lo = mid; else hi = mid;
    }
    const int skip = (k - first_block[lo]) * kPerBlock;
    desc[k] = make_int4(cursor[lo] + skip, min(kPerBlock, counts[lo] - skip),
                        offsets[lo], offsets[lo + 1]);
  }
}

__global__ void __launch_bounds__(kGroupThreads)
scatter_kernel(const int32_t* __restrict__ pkt_ep,
               const int32_t* __restrict__ pkt_ident,
               const int32_t* __restrict__ pkt_dport,
               const int32_t* __restrict__ pkt_proto,
               const int32_t* __restrict__ pkt_dir,
               const int32_t* __restrict__ pkt_len, int b, int n_ep,
               int32_t* __restrict__ cursor, int4* __restrict__ sorted) {
  extern __shared__ int32_t bins[];
  const bool shared = n_ep <= kSharedBins;
  if (shared) {
    for (int i = threadIdx.x; i < n_ep; i += kGroupThreads) bins[i] = 0;
  }
  __syncthreads();
  int ep[kGroupPerThread], at[kGroupPerThread];
#pragma unroll
  for (int k = 0; k < kGroupPerThread; ++k) {
    const int p = blockIdx.x * kChunk + k * kGroupThreads + threadIdx.x;
    ep[k] = valid_ep(pkt_ep, p, b, n_ep);
    // shared: rank within the block's bin; global: final position
    at[k] = warp_bump(shared ? bins : cursor, ep[k]);
  }
  __syncthreads();
  if (shared) {  // each bin's block-local count -> the block's base
    for (int i = threadIdx.x; i < n_ep; i += kGroupThreads) {
      if (bins[i]) bins[i] = atomicAdd(&cursor[i], bins[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kGroupPerThread; ++k) {
    if (ep[k] < 0) continue;
    const int p = blockIdx.x * kChunk + k * kGroupThreads + threadIdx.x;
    const uint32_t meta = pack_meta(static_cast<uint32_t>(pkt_dport[p]),
                                    static_cast<uint32_t>(pkt_proto[p]),
                                    static_cast<uint32_t>(pkt_dir[p]));
    sorted[at[k] + (shared ? bins[ep[k]] : 0)] = make_int4(
        p, pkt_ident[p], static_cast<int32_t>(meta), pkt_len[p]);
  }
}

__device__ __forceinline__ void cp_async16(int4* smem, const int4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void load_tile(int4* dst, const int4* src,
                                          int len) {
  for (int t = threadIdx.x; t < len; t += kThreads) {
    cp_async16(dst + t, src + t);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_verdict_kernel(const int4* __restrict__ entries, int n,
                       const int4* __restrict__ desc,
                       const int4* __restrict__ sorted,
                       int32_t* __restrict__ verdict,
                       int32_t* __restrict__ d_packets,
                       int32_t* __restrict__ d_bytes) {
  __shared__ __align__(16) int4 tile[2][kTile];
  const int4 d = desc[blockIdx.x];
  const int count = d.y;
  if (count == 0) return;  // a spare block
  const int seg_lo = d.z, seg_len = d.w - d.z;
  const int n_tiles = (seg_len + kTile - 1) / kTile;
  if (n_tiles > 0) load_tile(tile[0], entries + seg_lo, min(kTile, seg_len));
  cp_async_commit();

  // this thread's packets: records threadIdx.x + j * kThreads of the
  // block's group; a dead slot (past the count) keys on nothing real
  // and is neither written nor counted
  int32_t ident[kPerThread], mex[kPerThread], ml3[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = j * kThreads + threadIdx.x;
    const int4 r = q < count ? sorted[d.x + q] : make_int4(0, 0, 0, 0);
    ident[j] = r.y;
    mex[j] = r.z;
    ml3[j] = r.z & 3;  // pack_meta(0, 0, dir): the direction and valid bits
  }

  // Per-stage running sums, wrapping like the reference's int32 sums.
  uint32_t h1[kPerThread], v1[kPerThread], i1[kPerThread];
  uint32_t h2[kPerThread], i2[kPerThread];
  uint32_t h3[kPerThread], v3[kPerThread], i3[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    h1[j] = v1[j] = i1[j] = h2[j] = i2[j] = h3[j] = v3[j] = i3[j] = 0;
  }

  for (int k = 0; k < n_tiles; ++k) {
    const int base = k * kTile;
    if (k + 1 < n_tiles) {
      load_tile(tile[(k + 1) & 1], entries + seg_lo + base + kTile,
                min(kTile, seg_len - base - kTile));
    }
    cp_async_commit();
    cp_async_wait_one();  // tile k has landed
    __syncthreads();
    const int4* tl = tile[k & 1];
    const int len = min(kTile, seg_len - base);
    const uint32_t gi0 = static_cast<uint32_t>(seg_lo + base) + 1u;
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const int4 e = tl[t];
      const bool wild = e.y == 0;
      // Does any of the thread's packets hit this entry?  Three compares
      // a packet, each folding one AND or OR: stages 1 and 2 need the
      // identity and one of the two meta words, stage 3 the exact meta
      // word of some packet and a wildcard entry.
      bool keyed = false, exact = false;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const bool ex = e.z == mex[j];
        keyed |= (e.y == ident[j]) & (ex | (e.z == ml3[j]));
        exact |= ex;
      }
      if (keyed | (wild & exact)) {
        const uint32_t gi = gi0 + static_cast<uint32_t>(t);
        const uint32_t val = static_cast<uint32_t>(e.w);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const bool id = e.y == ident[j];
          const bool m1 = id & (e.z == mex[j]);
          const bool m2 = id & (e.z == ml3[j]);
          const bool m3 = wild & (e.z == mex[j]);
          h1[j] += m1; v1[j] += m1 ? val : 0u; i1[j] += m1 ? gi : 0u;
          h2[j] += m2; i2[j] += m2 ? gi : 0u;
          h3[j] += m3; v3[j] += m3 ? val : 0u; i3[j] += m3 ? gi : 0u;
        }
      }
    }
    __syncthreads();  // tile k is free for tile k + 2
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = j * kThreads + threadIdx.x;
    const bool live = q < count;
    int32_t out, win;
    if (static_cast<int32_t>(h1[j]) > 0) {
      out = static_cast<int32_t>(v1[j]);
      win = static_cast<int32_t>(i1[j]);
    } else if (static_cast<int32_t>(h2[j]) > 0) {
      out = 0;
      win = static_cast<int32_t>(i2[j]);
    } else if (static_cast<int32_t>(h3[j]) > 0) {
      out = static_cast<int32_t>(v3[j]);
      win = static_cast<int32_t>(i3[j]);
    } else {
      out = kDrop;
      win = 0;
    }
    int32_t len = 0;
    if (live) {
      const int4 r = sorted[d.x + q];
      verdict[r.x] = out;
      len = r.w;
    }
    // win is the deciding entry's index + 1 (0: nothing decided).  The
    // bound check keeps the atomics inside [0, n) whatever the table
    // holds.  Lanes deciding on the same entry add once, from a leader.
    const int key = live && win > 0 && win <= n ? win : 0;
    const unsigned peers = __match_any_sync(kFull, key);
    if (key) {
      const unsigned bytes =
          __reduce_add_sync(peers, static_cast<unsigned>(len));
      if (lane_id() == __ffs(peers) - 1) {
        atomicAdd(&d_packets[key - 1], __popc(peers));
        atomicAdd(&d_bytes[key - 1], static_cast<int32_t>(bytes));
      }
    }
  }
}

struct Scratch {
  int4* sorted;        // [B] packet records, grouped by endpoint
  int4* desc;          // [grid] verdict block descriptors
  int32_t* counts;     // [E] packets per endpoint
  int32_t* cursor;     // [E] next free sorted position per endpoint
  int32_t* first_block;  // [E] first verdict block per endpoint
};

int verdict_blocks(int b, int n_ep) {
  return (b + kPerBlock - 1) / kPerBlock + n_ep;
}

Scratch carve(int32_t* scratch, int b, int n_ep) {
  Scratch s;
  s.sorted = reinterpret_cast<int4*>(scratch);
  s.desc = s.sorted + b;
  s.counts = reinterpret_cast<int32_t*>(s.desc + verdict_blocks(b, n_ep));
  s.cursor = s.counts + n_ep;
  s.first_block = s.cursor + n_ep;
  return s;
}

}  // namespace

// int32 words of scratch the launch needs, 16-byte aligned at its start.
extern "C" long long dense_verdict_scratch_words(int b, int n_ep) {
  return 4LL * b + 4LL * verdict_blocks(b, n_ep) + 3LL * n_ep;
}

extern "C" int dense_verdict_launch(
    const int32_t* entries, int n, const int32_t* offsets, int n_ep,
    const int32_t* pkt_ep, const int32_t* pkt_ident,
    const int32_t* pkt_dport, const int32_t* pkt_proto,
    const int32_t* pkt_dir, const int32_t* pkt_len, int b,
    int32_t* verdict, int32_t* d_packets, int32_t* d_bytes,
    int32_t* scratch, int device, void* stream_ptr) {
  // This library links its own CUDA runtime: select the caller's device
  // before launching on the caller's stream.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Scratch s = carve(scratch, b, n_ep);
  const int grid = verdict_blocks(b, n_ep);
  const unsigned group_grid = static_cast<unsigned>((b + kChunk - 1) /
                                                    kChunk);
  const size_t bins = n_ep <= kSharedBins ? n_ep * sizeof(int32_t) : 0;

  const size_t entry_bytes = static_cast<size_t>(n) * sizeof(int32_t);
  if ((err = cudaMemsetAsync(d_packets, 0, entry_bytes, stream)) ||
      (err = cudaMemsetAsync(d_bytes, 0, entry_bytes, stream)) ||
      (err = cudaMemsetAsync(s.counts, 0, n_ep * sizeof(int32_t), stream))) {
    return static_cast<int>(err);
  }
  histogram_kernel<<<group_grid, kGroupThreads, bins, stream>>>(
      pkt_ep, b, n_ep, s.counts, verdict);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, 1024, 0, stream>>>(s.counts, offsets, n_ep, grid,
                                      s.cursor, s.first_block, s.desc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<group_grid, kGroupThreads, bins, stream>>>(
      pkt_ep, pkt_ident, pkt_dport, pkt_proto, pkt_dir, pkt_len, b, n_ep,
      s.cursor, s.sorted);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  segment_verdict_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(entries), n, s.desc, s.sorted, verdict,
      d_packets, d_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
