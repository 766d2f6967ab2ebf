// Radix-8 Viterbi add-compare-select + traceback for the DVB-S K=7,
// rate-1/2 code (G1 = 171, G2 = 133 octal), over overlapped segments.
//
// Replaces the Pallas TPU kernel of dvbs_tpu/ops/viterbi_pallas.py
// (_kernel, launched by pl.pallas_call in decode_segments_pallas). The
// TPU kernel keeps 512 lanes of segments in VMEM and walks the trellis
// with MXU expansion matmuls over a digit-swapped state layout; here
// one CTA decodes one segment, one thread per state:
//
//   - the segment's LLRs are rounded to bf16 (round to nearest even)
//     and staged in shared memory once, zero-padded to 3*nsteps pairs;
//   - step t (3 trellis steps) reads r = 6 LLRs; thread ns = hi*8 + lo
//     forms, for each fused input j, the candidate
//     pm[lo*8 + j] + sum_q sign(ns, j, q) * r[q], the sum taken q = 0..5
//     in order, each add rounded on its own (__fadd_rn), and keeps the
//     maximum by the TPU kernel's tournament: (j, j+4), (j, j+2),
//     (j, j+1), strict '>' so a tie keeps the lower operand;
//   - no normalization (as the TPU kernel): with bf16 LLRs of the
//     receiver's range the path metrics stay far from float32 overflow;
//   - decisions (nsteps x 64 bytes) stay in shared memory; after the
//     forward pass one thread traces back from state 0 into a shared
//     bit buffer, and the CTA writes the bits out coalesced.
//
// The plain PyTorch version (ops/viterbi_kernel.decode_plain) sums in
// the same order, so the two agree bit for bit.
//
// What bounds it: latency. Each of the 235 steps of a 704-pair segment
// is ~60 dependent instructions and one barrier; the bytes (23 MB of
// LLRs in, 2.9 MB of bits out for the bank's 4096 segments) take a few
// microseconds of DRAM time. Many small CTAs (64 threads, ~22 KB of
// shared memory) keep ~10 segments in flight per SM to hide the
// per-step latency. A warp per segment, several segments per CTA and
// bit-packed decisions are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 64;        // states
constexpr int R = 8;          // fused inputs per step (radix 8)
constexpr int K = 3;          // trellis steps per step
constexpr int G1 = 0171;
constexpr int G2 = 0133;

__device__ __forceinline__ int parity(int v) { return __popc(v) & 1; }

// 6-bit pattern of the fused branch lo*8 + j -> ns: bit q set when the
// q-th expected output (earliest (X, Y) first) is 1, i.e. its sign is
// -1 (tables.trellis_k(3)).
__device__ int branch_pattern(int ns, int j) {
  int s = ((ns & 7) << K) | j;
  int pat = 0;
  for (int i = 0; i < K; ++i) {
    const int b = (ns >> (6 - K + i)) & 1;
    const int v = (b << 6) | s;
    pat |= parity(v & G1) << (2 * i);
    pat |= parity(v & G2) << (2 * i + 1);
    s = (b << 5) | (s >> 1);
  }
  return pat;
}

__global__ void __launch_bounds__(NS)
viterbi_acs_kernel(const float* __restrict__ llrs, int T, int nsteps,
                   uint8_t* __restrict__ bits) {
  extern __shared__ float smem[];
  float* pm = smem;                                  // [2][64]
  float* xs = pm + 2 * NS;                           // [6 * nsteps]
  uint8_t* dec = reinterpret_cast<uint8_t*>(xs + 6 * nsteps);  // [nsteps][64]
  uint8_t* obits = dec + (size_t)nsteps * NS;        // [3 * nsteps]

  const int ns = threadIdx.x;
  const size_t seg = blockIdx.x;
  const float* x = llrs + seg * (size_t)T * 2;
  for (int i = ns; i < 6 * nsteps; i += NS) {
    const float v = i < 2 * T ? x[i] : 0.f;
    xs[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  uint8_t pat[R];
#pragma unroll
  for (int j = 0; j < R; ++j) pat[j] = (uint8_t)branch_pattern(ns, j);
  pm[ns] = 0.f;
  __syncthreads();

  const int lo8 = (ns & 7) * R;
  for (int t = 0; t < nsteps; ++t) {
    const float* cur = pm + (t & 1) * NS;
    float* nxt = pm + ((t + 1) & 1) * NS;
    const float* r = xs + 6 * t;
    float c[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int p = pat[j];
      float bm = (p & 1) ? -r[0] : r[0];
#pragma unroll
      for (int q = 1; q < 6; ++q)
        bm = __fadd_rn(bm, ((p >> q) & 1) ? -r[q] : r[q]);
      c[j] = __fadd_rn(cur[lo8 + j], bm);
    }
    int idx[R];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool w = c[j + 4] > c[j];
      c[j] = w ? c[j + 4] : c[j];
      idx[j] = w ? 4 : 0;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool w = c[j + 2] > c[j];
      c[j] = w ? c[j + 2] : c[j];
      idx[j] = w ? idx[j + 2] + 2 : idx[j];
    }
    const bool w = c[1] > c[0];
    nxt[ns] = w ? c[1] : c[0];
    dec[(size_t)t * NS + ns] = (uint8_t)(w ? idx[1] + 1 : idx[0]);
    __syncthreads();
  }

  if (ns == 0) {
    int s = 0;
    for (int t = nsteps - 1; t >= 0; --t) {
#pragma unroll
      for (int i = 0; i < K; ++i) obits[K * t + i] = (s >> (K + i)) & 1;
      s = (s & 7) * R + dec[(size_t)t * NS + s];
    }
  }
  __syncthreads();
  uint8_t* out = bits + seg * (size_t)T;
  for (int i = ns; i < T; i += NS) out[i] = obits[i];
}

}  // namespace

// llrs [B, T, 2] float32 -> bits [B, T] uint8, one CTA per segment.
// Returns cudaGetLastError() after the launch (or the error of raising
// the CTA's shared-memory limit).
extern "C" int viterbi_acs(void* llrs, int B, int T, void* bits,
                           void* stream) {
  const int nsteps = (T + K - 1) / K;
  const size_t smem = (2 * NS + 6 * (size_t)nsteps) * sizeof(float) +
                      (size_t)nsteps * NS + (size_t)K * nsteps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_acs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_acs_kernel<<<B, NS, smem, (cudaStream_t)stream>>>(
      (const float*)llrs, T, nsteps, (uint8_t*)bits);
  return (int)cudaGetLastError();
}
