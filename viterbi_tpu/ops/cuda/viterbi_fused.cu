// Fused K=7 rate-1/4 Viterbi decode for NVIDIA Hopper (sm_90a).
//
// One thread decodes one frame. The whole trellis loop runs inside the
// kernel with the 64 path metrics in registers (one u32 per state, the
// butterfly's state permutation is plain register renaming after full
// unrolling); each step's 64 decisions are packed into the reference's
// two-u32 decision_t words (bit s of word s/32, viterbi.h:89-92) and
// written to a time-major scratch buffer, which the same thread then
// walks back from state 0 (chainback.inc:18-41). Inputs and scratch are
// time-major [step][frame], so every load and store of a warp is one
// coalesced 128-byte transaction; both loops prefetch the next block of
// kBlock steps into registers before working on the current one.
//
// Numerics are the reference's saturating-u8 ACS, bit for bit (see
// viterbi_tpu/ops/acs.py): rounding-average branch metrics, adds capped
// at 255, ties to the high predecessor, and a renormalization by 63
// after every second step when state 0's metric exceeds 150.
//
// The per-frame code is plain C++ shared by the device kernel and a host
// build (compiled with a C++ compiler, no CUDA), which the CPU tests run
// against the golden model.

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define VIT_HD __host__ __device__ __forceinline__
#define VIT_CX __host__ __device__ constexpr
#define VIT_UNROLL _Pragma("unroll")
#else
#define VIT_HD inline
#define VIT_CX constexpr
#define VIT_UNROLL
#endif

namespace vit {

constexpr int kTail = 6;             // flush bits of the terminated trellis
constexpr int kBlock = 16;           // trellis steps per prefetch block
constexpr uint32_t kMetricMax = 255;
constexpr uint32_t kRenormThreshold = 150;
constexpr uint32_t kRenormSub = 63;

VIT_CX uint32_t parity(uint32_t x) {
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 1u;
}

// Polarity pattern (p0, p1, p2) of butterfly b: p_j = parity((b << 1) &
// g_j) for the generators {109, 79, 83, 109}; g3 == g0, so p3 == p0.
VIT_CX int pattern(int b) {
  return static_cast<int>((parity((b << 1) & 109) << 2) |
                          (parity((b << 1) & 79) << 1) |
                          parity((b << 1) & 83));
}

VIT_HD uint32_t avg(uint32_t x, uint32_t y) { return (x + y + 1) >> 1; }

VIT_HD uint32_t umin(uint32_t x, uint32_t y) { return x < y ? x : y; }

// Branch metrics of the 8 polarity patterns for one trellis step whose
// four soft symbols are packed little-endian in `w` (symbol j in byte j).
VIT_HD void branch_metrics(uint32_t w, uint32_t bm[8]) {
  uint32_t s0 = w & 255u, s1 = (w >> 8) & 255u, s2 = (w >> 16) & 255u,
           s3 = w >> 24;
  uint32_t h01[4], h23[4];
  VIT_UNROLL
  for (int q = 0; q < 4; ++q) {
    // h01 indexed by (p0, p1), h23 by (p2, p0)
    h01[q] = avg((q & 2) ? 255u - s0 : s0, (q & 1) ? 255u - s1 : s1);
    h23[q] = avg((q & 2) ? 255u - s2 : s2, (q & 1) ? 255u - s3 : s3);
  }
  VIT_UNROLL
  for (int p = 0; p < 8; ++p) {
    int p0 = (p >> 2) & 1, p1 = (p >> 1) & 1, p2 = p & 1;
    bm[p] = avg(h01[(p0 << 1) | p1], h23[(p2 << 1) | p0]) >> 2;
  }
}

// One add-compare-select step over all 64 states; returns the packed
// decision words through d0 (states 0..31) and d1 (states 32..63).
VIT_HD void acs_step(uint32_t m[64], uint32_t w, uint32_t& d0,
                     uint32_t& d1) {
  uint32_t bm[8];
  branch_metrics(w, bm);
  uint32_t nm[64];
  d0 = 0;
  d1 = 0;
  // high states first so each word fills from bit 31 down to bit 0
  VIT_UNROLL
  for (int b = 31; b >= 0; --b) {
    uint32_t mb = bm[pattern(b)], cb = 63u - mb;
    uint32_t lo = m[b], hi = m[b + 32];
    uint32_t p0e = umin(lo + mb, kMetricMax), p1e = umin(hi + cb, kMetricMax);
    uint32_t p0o = umin(lo + cb, kMetricMax), p1o = umin(hi + mb, kMetricMax);
    nm[2 * b] = umin(p0e, p1e);
    nm[2 * b + 1] = umin(p0o, p1o);
    uint32_t& d = b >= 16 ? d1 : d0;
    d = (d << 1) | static_cast<uint32_t>(p1o <= p0o);
    d = (d << 1) | static_cast<uint32_t>(p1e <= p0e);
  }
  VIT_UNROLL
  for (int s = 0; s < 64; ++s) m[s] = nm[s];
}

VIT_HD void renormalize(uint32_t m[64]) {
  uint32_t sub = m[0] > kRenormThreshold ? kRenormSub : 0u;
  VIT_UNROLL
  for (int s = 0; s < 64; ++s) m[s] = (m[s] > sub ? m[s] : sub) - sub;
}

// Decode frame f. syms: [nblocks*kBlock][ld] packed steps; dec: scratch
// [nblocks*kBlock][2][ld]; out: [ceil(framebits/32)][ld] words holding
// data bits MSB-first. Steps at or past nsteps are computed but never
// read back.
VIT_HD void decode_frame(const uint32_t* syms, uint32_t* dec, uint32_t* out,
                         size_t ld, size_t f, int nsteps, int nblocks) {
  uint32_t m[64];
  VIT_UNROLL
  for (int s = 0; s < 64; ++s) m[s] = s == 0 ? 0u : 63u;

  uint32_t cur[kBlock], nxt[kBlock];
  VIT_UNROLL
  for (int i = 0; i < kBlock; ++i) cur[i] = syms[i * ld + f];
  for (int blk = 0; blk < nblocks; ++blk) {
    if (blk + 1 < nblocks) {
      VIT_UNROLL
      for (int i = 0; i < kBlock; ++i)
        nxt[i] = syms[((blk + 1) * kBlock + i) * ld + f];
    }
    VIT_UNROLL
    for (int i = 0; i < kBlock; ++i) {
      size_t t = static_cast<size_t>(blk) * kBlock + i;
      uint32_t d0, d1;
      acs_step(m, cur[i], d0, d1);
      if (i & 1) renormalize(m);  // kBlock is even: i odd <=> t odd
      dec[(2 * t) * ld + f] = d0;
      dec[(2 * t + 1) * ld + f] = d1;
    }
    VIT_UNROLL
    for (int i = 0; i < kBlock; ++i) cur[i] = nxt[i];
  }

  // Traceback from state 0 at step nsteps; the decision at step t is
  // data bit t - kTail.
  uint32_t lo[kBlock], hi[kBlock], nlo[kBlock], nhi[kBlock];
  int last = (nsteps - 1) / kBlock;
  VIT_UNROLL
  for (int i = 0; i < kBlock; ++i) {
    size_t t = static_cast<size_t>(last) * kBlock + i;
    lo[i] = dec[(2 * t) * ld + f];
    hi[i] = dec[(2 * t + 1) * ld + f];
  }
  uint32_t state = 0, acc = 0;
  for (int blk = last; blk >= 0; --blk) {
    if (blk > 0) {
      VIT_UNROLL
      for (int i = 0; i < kBlock; ++i) {
        size_t t = static_cast<size_t>(blk - 1) * kBlock + i;
        nlo[i] = dec[(2 * t) * ld + f];
        nhi[i] = dec[(2 * t + 1) * ld + f];
      }
    }
    VIT_UNROLL
    for (int i = kBlock - 1; i >= 0; --i) {
      int t = blk * kBlock + i;
      if (t < nsteps && t >= kTail) {
        uint32_t word = state >= 32 ? hi[i] : lo[i];
        uint32_t k = (word >> (state & 31)) & 1u;
        state = (state >> 1) | (k << 5);
        int bit = t - kTail;
        acc |= k << (31 - (bit & 31));
        if ((bit & 31) == 0) {
          out[static_cast<size_t>(bit >> 5) * ld + f] = acc;
          acc = 0;
        }
      }
    }
    VIT_UNROLL
    for (int i = 0; i < kBlock; ++i) {
      lo[i] = nlo[i];
      hi[i] = nhi[i];
    }
  }
}

}  // namespace vit

#ifdef __CUDACC__

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    fused_decode_kernel(const uint32_t* __restrict__ syms,
                        uint32_t* __restrict__ dec,
                        uint32_t* __restrict__ out, int64_t ld,
                        int64_t nframes, int nsteps, int nblocks) {
  int64_t f = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= nframes) return;
  vit::decode_frame(syms, dec, out, static_cast<size_t>(ld),
                    static_cast<size_t>(f), nsteps, nblocks);
}

ffi::Error FusedDecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> syms,
                           ffi::ResultBuffer<ffi::U32> out,
                           ffi::ResultBuffer<ffi::U32> dec, int64_t nsteps,
                           int64_t nframes) {
  auto sd = syms.dimensions();
  auto od = out->dimensions();
  auto dd = dec->dimensions();
  if (sd.size() != 2 || od.size() != 2 || dd.size() != 3)
    return ffi::Error::InvalidArgument("viterbi_fused: bad ranks");
  int64_t steps = sd[0], ld = sd[1];
  int64_t framebits = nsteps - vit::kTail;
  if (steps % vit::kBlock || nsteps > steps || framebits < 1 ||
      nframes > ld || od[0] != (framebits + 31) / 32 || od[1] != ld ||
      dd[0] != steps || dd[1] != 2 || dd[2] != ld)
    return ffi::Error::InvalidArgument("viterbi_fused: bad shapes");
  if (nframes == 0) return ffi::Error::Success();
  int64_t blocks = (nframes + kThreads - 1) / kThreads;
  fused_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(
      syms.typed_data(), dec->typed_data(), out->typed_data(), ld, nframes,
      static_cast<int>(nsteps), static_cast<int>(steps / vit::kBlock));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ViterbiFusedDecode, FusedDecodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("nsteps")
                                  .Attr<int64_t>("nframes"));

#else  // host build for the CPU tests

extern "C" void vit_decode_host(const uint32_t* syms, uint32_t* dec,
                                uint32_t* out, int64_t ld, int64_t nframes,
                                int nsteps, int nblocks) {
  for (int64_t f = 0; f < nframes; ++f)
    vit::decode_frame(syms, dec, out, static_cast<size_t>(ld),
                      static_cast<size_t>(f), nsteps, nblocks);
}

#endif
