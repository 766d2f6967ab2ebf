// Radix-8 Viterbi add-compare-select + traceback for the DVB-S K=7,
// rate-1/2 code (G1 = 171, G2 = 133 octal), over overlapped segments.
//
// Replaces the Pallas TPU kernel of dvbs_tpu/ops/viterbi_pallas.py
// (_kernel, launched by pl.pallas_call in decode_segments_pallas). The
// TPU kernel keeps 512 lanes of segments in VMEM and walks the trellis
// with MXU expansion matmuls over a digit-swapped state layout. What is
// computed here is the same, bit for bit:
//
//   - the segment's LLRs are rounded to bf16 (round to nearest even)
//     and staged in shared memory once, zero-padded to 3*nsteps pairs;
//   - step t (3 trellis steps) reads r = 6 LLRs; state ns = hi*8 + lo
//     forms, for each fused input j, the candidate
//     pm[lo*8 + j] + sum_q sign(ns, j, q) * r[q], the sum taken q = 0..5
//     in order, each add rounded on its own, and keeps the maximum by
//     the TPU kernel's tournament: (j, j+4), (j, j+2), (j, j+1), strict
//     '>' so a tie keeps the lower operand;
//   - no normalization (as the TPU kernel): with bf16 LLRs of the
//     receiver's range the path metrics stay far from float32 overflow;
//   - traceback from state 0; the bits go out coalesced.
//
// What bounds it on Hopper: instruction issue, with the SM's
// shared-memory pipe close behind. The bytes (23 MB of LLRs in, 2.9 MB
// of bits out for the bank's 4096 segments) take a few microseconds. A
// step of a segment is about 100 instructions a warp (the tournament's
// 14 compares and 40 selects are most of them), of which 16 go to
// shared memory in about 26 passes of its 128-byte data path, which the
// four schedulers of an SM share; the serial traceback adds an eighth.
// What the design does about both:
//   - a warp decodes a segment, a lane two states of one lo (so both
//     read the same eight predecessors), and a CTA holds four segments;
//     no CTA-wide barrier anywhere, one __syncwarp a step;
//   - a step has only 64 distinct branch sums, one per sign pattern of
//     its 6 LLRs, and the pattern with every sign flipped has exactly
//     the negated sum (rounding to nearest is symmetric). So each lane
//     forms one sum a step, pattern = its lane number with +r[5], one
//     step ahead and off the dependent chain, into a 32-entry table in
//     shared memory; a state reads its 8 by the pattern it holds and
//     applies the sign inside the add (fma(sum, +-1, pm) rounds once,
//     as pm + (+-sum) does);
//   - a lane's two states are ns and ns ^ 40 (hi and hi ^ 5): the
//     branch into ns ^ 40 from input j expects exactly the complement
//     of the branch into ns from input j ^ 4, so the second state's
//     eight branch metrics are the first's, negated and swapped in
//     halves, and eight table reads a step serve both states;
//   - path metrics pass from step to step through a warp-private,
//     double-buffered strip of shared memory: two stores, two 16-byte
//     loads (the predecessors lo*8 .. lo*8+7 are consecutive; a 4-float
//     gap after the first 32 keeps the loads off each other's banks);
//   - decisions are a nibble a state, 32 bytes a step (a byte a state
//     made 64), so four CTAs of four segments fit an SM;
//   - the traceback stays serial per segment (one lane); the other
//     warps of the SM run forward meanwhile.
//
// The plain PyTorch version (ops/viterbi_kernel.decode_plain) sums in
// the same order, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;          // fused inputs per step (radix 8)
constexpr int K = 3;          // trellis steps per step
constexpr int G1 = 0171;
constexpr int G2 = 0133;
constexpr int PM_ROW = 68;    // 64 path metrics + the 4-float gap
constexpr int BM_ROW = 32;    // branch sums of the patterns 0..31
// bytes a warp keeps besides its steps' LLRs and decisions; the Python
// wrapper's smem_bytes repeats this layout
constexpr int WARP_FIXED = (2 * PM_ROW + 2 * BM_ROW) * 4;
constexpr int STEP_BYTES = 6 * 4 + 32;   // 6 LLRs, 32 decision bytes

__host__ __device__ inline int warp_bytes(int nsteps) {
  return (WARP_FIXED + STEP_BYTES * nsteps + 15) & ~15;
}

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

// where path metric s lies in a strip
__device__ __forceinline__ int pm_pos(int s) { return s + ((s >> 5) << 2); }

// the tournament over the 8 candidates of one state
__device__ __forceinline__ void tournament(const float (&c)[R], float& best,
                                           int& dec) {
  float a[4];
  int ia[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool w = c[j + 4] > c[j];
    a[j] = w ? c[j + 4] : c[j];
    ia[j] = w ? j + 4 : j;
  }
  float b[2];
  int ib[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool w = a[j + 2] > a[j];
    b[j] = w ? a[j + 2] : a[j];
    ib[j] = w ? ia[j + 2] : ia[j];
  }
  const bool w = b[1] > b[0];
  best = w ? b[1] : b[0];
  dec = w ? ib[1] : ib[0];
}

// what a lane holds for the whole segment
struct Lane {
  int lane;
  int rd;             // strip position of its 8 predecessors
  int wr0, wr1;       // strip positions of its two states
  int i0[R];          // table index of the first state's branch sums
  float s0[R];        // and their signs
  float ps[5];        // signs of the sum this lane forms
};

// the branch sum of pattern `lane` (bit 5 clear) for step t, q = 0..5 in
// order, each add rounded alone: r*(+-1) is exact, fma(r, +-1, acc)
// rounds acc +- r once
__device__ __forceinline__ float branch_sum(const float* xs, int t,
                                            const Lane& L) {
  const float2* r = reinterpret_cast<const float2*>(xs + 6 * t);
  const float2 r01 = r[0], r23 = r[1], r45 = r[2];
  float acc = __fmul_rn(r01.x, L.ps[0]);
  acc = __fmaf_rn(r01.y, L.ps[1], acc);
  acc = __fmaf_rn(r23.x, L.ps[2], acc);
  acc = __fmaf_rn(r23.y, L.ps[3], acc);
  acc = __fmaf_rn(r45.x, L.ps[4], acc);
  return __fadd_rn(acc, r45.y);
}

// step t: reads strip and table PAR, writes strip PAR ^ 1 and, for step
// t + 1, table PAR ^ 1
template <int PAR>
__device__ __forceinline__ void acs_step(int t, int nsteps, float* pm,
                                         float* bm, const float* xs,
                                         uint8_t* dec, const Lane& L) {
  const float* pmr = pm + PAR * PM_ROW;
  float* pmw = pm + (PAR ^ 1) * PM_ROW;
  const float* bmr = bm + PAR * BM_ROW;
  const float4 pa = *reinterpret_cast<const float4*>(pmr + L.rd);
  const float4 pb = *reinterpret_cast<const float4*>(pmr + L.rd + 4);
  const float p[R] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
  float b[R], c0[R], c1[R];
#pragma unroll
  for (int j = 0; j < R; ++j) b[j] = bmr[L.i0[j]];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    c0[j] = __fmaf_rn(b[j], L.s0[j], p[j]);
    c1[j] = __fmaf_rn(b[j ^ 4], -L.s0[j ^ 4], p[j]);   // see struct Lane
  }
  if (t + 1 < nsteps)
    bm[(PAR ^ 1) * BM_ROW + L.lane] = branch_sum(xs, t + 1, L);
  float v0, v1;
  int d0, d1;
  tournament(c0, v0, d0);
  tournament(c1, v1, d1);
  pmw[L.wr0] = v0;
  pmw[L.wr1] = v1;
  dec[t * 32 + L.lane] = (uint8_t)(d0 | (d1 << 4));
  __syncwarp();
}

__global__ void __launch_bounds__(128, 4)
viterbi_acs_kernel(const float* __restrict__ llrs, int B, int T, int nsteps,
                   uint8_t* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * (blockDim.x >> 5) + warp;
  if (seg >= B) return;                  // the ragged last CTA

  unsigned char* mine = smem + (size_t)warp * warp_bytes(nsteps);
  float* pm = reinterpret_cast<float*>(mine);           // [2][PM_ROW]
  float* bm = pm + 2 * PM_ROW;                          // [2][BM_ROW]
  float* xs = bm + 2 * BM_ROW;                          // [6 * nsteps]
  uint8_t* dec = reinterpret_cast<uint8_t*>(xs + 6 * nsteps);  // [nsteps][32]

  // the segment's LLRs, rounded to bf16, a pair a lane and pass
  const float2* x = reinterpret_cast<const float2*>(llrs) + (size_t)seg * T;
  float2* xs2 = reinterpret_cast<float2*>(xs);
  for (int i = lane; i < 3 * nsteps; i += 32) {
    const float2 v = i < T ? x[i] : make_float2(0.f, 0.f);
    xs2[i] = make_float2(__bfloat162float(__float2bfloat16_rn(v.x)),
                         __bfloat162float(__float2bfloat16_rn(v.y)));
  }

  // lane = a*8 + lo holds the states (a, lo) and (a ^ 5, lo)
  Lane L;
  L.lane = lane;
  const int lo = lane & 7;
  const int ns0 = lane, ns1 = lane ^ 40;
  L.rd = pm_pos(lo * R);
  L.wr0 = pm_pos(ns0);
  L.wr1 = pm_pos(ns1);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int p0 = branch_pattern(ns0, j);
    L.i0[j] = (p0 & 32) ? (~p0 & 31) : p0;
    L.s0[j] = (p0 & 32) ? -1.f : 1.f;
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) L.ps[q] = ((lane >> q) & 1) ? -1.f : 1.f;

  for (int i = lane; i < PM_ROW; i += 32) pm[i] = 0.f;
  __syncwarp();                          // xs is whole
  bm[lane] = branch_sum(xs, 0, L);
  __syncwarp();

  int t = 0;
  for (; t + 1 < nsteps; t += 2) {
    acs_step<0>(t, nsteps, pm, bm, xs, dec, L);
    acs_step<1>(t + 1, nsteps, pm, bm, xs, dec, L);
  }
  if (t < nsteps) acs_step<0>(t, nsteps, pm, bm, xs, dec, L);

  // traceback from state 0: the state at each step's end goes where the
  // LLRs were; state s lies in nibble s >> 5 of lane s (s < 32) or
  // s ^ 40 (else)
  uint8_t* trace = reinterpret_cast<uint8_t*>(xs);
  if (lane == 0) {
    int s = 0;
    for (int u = nsteps - 1; u >= 0; --u) {
      trace[u] = (uint8_t)s;
      const int hi = s >> 5;
      const int d = (dec[u * 32 + ((s & 31) ^ (hi << 3))] >> (hi << 2)) & 7;
      s = (s & 7) * R + d;
    }
  }
  __syncwarp();
  // bit 3u + i is bit 3 + i of the state after step u
  uint8_t* out = bits + (size_t)seg * T;
  for (int i = lane; i < T; i += 32) {
    const int u = i / K;
    out[i] = (trace[u] >> (K + i - K * u)) & 1;
  }
}

}  // namespace

// llrs [B, T, 2] float32 -> bits [B, T] uint8, a warp per segment, four
// segments per CTA; one per CTA where four do not fit its shared memory
// (T beyond about 3,000 pairs), and cudaErrorInvalidValue where one
// does not. Returns cudaGetLastError() after the launch (or the error
// of raising the CTA's shared-memory limit). The limit is raised once a
// process: one device a process.
extern "C" int viterbi_acs(void* llrs, int B, int T, void* bits,
                           void* stream) {
  constexpr int SMEM_LIMIT = 227 * 1024;  // a Hopper CTA's
  const int nsteps = (T + K - 1) / K;
  const int warps = 4 * warp_bytes(nsteps) <= SMEM_LIMIT ? 4 : 1;
  const int smem = warps * warp_bytes(nsteps);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;       // largest size allowed so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_acs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  viterbi_acs_kernel<<<(B + warps - 1) / warps, 32 * warps, smem,
                       (cudaStream_t)stream>>>(
      (const float*)llrs, B, T, nsteps, (uint8_t*)bits);
  return (int)cudaGetLastError();
}
