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
// What bounds it: integer compare throughput.  On a miss, every (packet,
// entry) pair issues about nine instructions on the ALU pipe (eight
// ISETP, which fold the ANDs into their predicate inputs, and one PLOP3
// for the any-hit test) and about fourteen in all; the ALU pipe has 64
// lanes per SM, so B x N x ~9 over 64 x 132 SMs x 1.98 GHz.  The SASS
// read by cilium_tpu_torch/sass_mix.py gives the exact counts.  The
// bytes moved, (N x 4 + B x 7) x 4, are negligible beside it.
// The design keeps every one of those operations on registers and one
// broadcast shared-memory read:
//   - one thread per packet; its endpoint, identity and two meta words
//     are packed once into registers (meta words built in uint32, so a
//     port >= 32768 lands in the sign bit without signed-shift UB);
//   - the entry axis streams through shared memory in tiles of kTile
//     entries as int4 (ep, key_a, key_b, value): all threads of a warp
//     read the same entry, a single broadcast 16-byte load per pair;
//   - per-stage running (hits, value sum, index+1 sum) stay in
//     registers across tiles.  Keys are unique per endpoint, so at most
//     one entry hits per stage and the sums select it, as in the Pallas
//     kernel.  Hits are rare, so the accumulate sits behind a branch
//     that a warp almost never takes;
//   - precedence is resolved in the kernel, and the deciding entry's
//     counters are bumped with int32 atomicAdd (wrapping, the bits of
//     the reference's uint32 counters).
// The ragged tails of both axes are masked here, so any B and any N is
// taken.  Left for later: cp.async/TMA double-buffering of the tiles,
// and walking only the packet's endpoint segment (compile_dense stores
// each endpoint's entries contiguously), which is 1/E of the compares.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;   // packets per block, one per thread
constexpr int kTile = 2048;   // entries per shared-memory tile (32 KB)

__device__ __forceinline__ uint32_t pack_meta(uint32_t dport,
                                              uint32_t proto,
                                              uint32_t dir) {
  return ((dport & 0xFFFFu) << 16) | ((proto & 0xFFu) << 8) |
         ((dir & 1u) << 1) | 1u;
}

__global__ void __launch_bounds__(kBlock)
dense_verdict_kernel(const int32_t* __restrict__ ent_ep,
                     const int32_t* __restrict__ ent_key_a,
                     const int32_t* __restrict__ ent_key_b,
                     const int32_t* __restrict__ ent_value, int n,
                     const int32_t* __restrict__ pkt_ep,
                     const int32_t* __restrict__ pkt_ident,
                     const int32_t* __restrict__ pkt_dport,
                     const int32_t* __restrict__ pkt_proto,
                     const int32_t* __restrict__ pkt_dir,
                     const int32_t* __restrict__ pkt_len, int b,
                     int32_t* __restrict__ verdict,
                     int32_t* __restrict__ d_packets,
                     int32_t* __restrict__ d_bytes) {
  __shared__ int4 tile[kTile];
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < b;

  int32_t ep = -1, ident = 0;
  int32_t meta_exact = 0, meta_l3 = 0;
  if (live) {
    ep = pkt_ep[p];
    ident = pkt_ident[p];
    const uint32_t dir = static_cast<uint32_t>(pkt_dir[p]);
    meta_exact = static_cast<int32_t>(
        pack_meta(static_cast<uint32_t>(pkt_dport[p]),
                  static_cast<uint32_t>(pkt_proto[p]), dir));
    meta_l3 = static_cast<int32_t>(pack_meta(0u, 0u, dir));
  }

  // Per-stage running sums, wrapping like the reference's int32 sums.
  uint32_t h1 = 0, v1 = 0, i1 = 0, h2 = 0, i2 = 0, h3 = 0, v3 = 0, i3 = 0;

  for (int base = 0; base < n; base += kTile) {
    const int len = min(kTile, n - base);
    for (int t = threadIdx.x; t < len; t += kBlock) {
      tile[t] = make_int4(ent_ep[base + t], ent_key_a[base + t],
                          ent_key_b[base + t], ent_value[base + t]);
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int t = 0; t < len; ++t) {
        const int4 e = tile[t];
        const bool same = e.x == ep;
        const bool m1 = same & (e.y == ident) & (e.z == meta_exact);
        const bool m2 = same & (e.y == ident) & (e.z == meta_l3);
        const bool m3 = same & (e.y == 0) & (e.z == meta_exact);
        if (m1 | m2 | m3) {
          const uint32_t gi = static_cast<uint32_t>(base + t) + 1u;
          const uint32_t val = static_cast<uint32_t>(e.w);
          h1 += m1; v1 += m1 ? val : 0u; i1 += m1 ? gi : 0u;
          h2 += m2; i2 += m2 ? gi : 0u;
          h3 += m3; v3 += m3 ? val : 0u; i3 += m3 ? gi : 0u;
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;

  int32_t out, win;
  if (static_cast<int32_t>(h1) > 0) {
    out = static_cast<int32_t>(v1);
    win = static_cast<int32_t>(i1);
  } else if (static_cast<int32_t>(h2) > 0) {
    out = 0;
    win = static_cast<int32_t>(i2);
  } else if (static_cast<int32_t>(h3) > 0) {
    out = static_cast<int32_t>(v3);
    win = static_cast<int32_t>(i3);
  } else {
    out = -1;
    win = 0;
  }
  verdict[p] = out;
  // win is the deciding entry's index + 1 (0: nothing decided).  The
  // bound check keeps the atomics inside [0, n) whatever the table holds.
  if (win > 0 && win <= n) {
    atomicAdd(&d_packets[win - 1], 1);
    atomicAdd(&d_bytes[win - 1], pkt_len[p]);
  }
}

}  // namespace

extern "C" int dense_verdict_launch(
    const int32_t* ent_ep, const int32_t* ent_key_a,
    const int32_t* ent_key_b, const int32_t* ent_value, int n,
    const int32_t* pkt_ep, const int32_t* pkt_ident,
    const int32_t* pkt_dport, const int32_t* pkt_proto,
    const int32_t* pkt_dir, const int32_t* pkt_len, int b,
    int32_t* verdict, int32_t* d_packets, int32_t* d_bytes,
    int device, void* stream) {
  // This library links its own CUDA runtime: select the caller's device
  // before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned grid = static_cast<unsigned>((b + kBlock - 1) / kBlock);
  dense_verdict_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ent_ep, ent_key_a, ent_key_b, ent_value, n, pkt_ep, pkt_ident,
      pkt_dport, pkt_proto, pkt_dir, pkt_len, b, verdict, d_packets,
      d_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
