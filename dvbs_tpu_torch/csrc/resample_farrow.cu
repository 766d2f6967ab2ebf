// Timing-recovery interpolator: per-tile integer shift + 10-tap Farrow.
//
// Replaces the Pallas TPU kernel of dvbs_tpu/ops/resample_pallas.py
// (_kernel, launched by pl.pallas_call in _resample_core). The TPU kernel
// aligns each 256-symbol tile by a masked barrel shifter over parity
// planes, because gathers serialise there; on Hopper a direct windowed
// read per symbol is legal, so each thread reads its own 10 samples:
//
//   out[c, k] = sum_{t=0..9} tap_t(u[c, k]) * y[c, 2*TS*ti + rb - bias + 2*j + t - 4]
//
// with ti = k / TS, j = k % TS, rb the tile's biased shift, tap_t
// Horner's rule over the fitted coefficients (highest power first), and
// a read outside [0, n2) taken as 0 (the zero-padded buffer of
// frontend.resample_windowed). Multiplies and adds are rounded one by
// one (__fmul_rn / __fadd_rn, no FMA contraction), in the order of the
// plain PyTorch version, so the two agree to rounding of the inputs.
//
// What bounds it: bytes. Per symbol it reads 10 neighbouring complex
// samples (served by L1: neighbouring threads overlap), one band
// coordinate and writes one complex value: ~28 B of DRAM traffic per
// symbol, ~0.12 GB per 8-carrier bank block, against ~200 flops per
// symbol. One block per 256-symbol tile and carrier; the 100
// coefficients sit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 256;
constexpr int TAPS = 10;
constexpr int DEG = 9;

__global__ void __launch_bounds__(TS)
farrow_kernel(const float2* __restrict__ y, int n2,
              const float* __restrict__ u, const int* __restrict__ rb,
              int S, int nt, int bias, const float* __restrict__ coef,
              float2* __restrict__ out) {
  __shared__ float cs[TAPS * (DEG + 1)];
  for (int k = threadIdx.x; k < TAPS * (DEG + 1); k += blockDim.x)
    cs[k] = coef[k];
  __syncthreads();
  const int c = blockIdx.y;
  const int ti = blockIdx.x;
  const int j = threadIdx.x;
  const int k = ti * TS + j;
  if (k >= S) return;
  const float uu = u[(size_t)c * nt * TS + k];
  const long base = 2L * TS * ti + (rb[c * nt + ti] - bias) + 2 * j - 4;
  const float2* yc = y + (size_t)c * n2;
  float re = 0.f, im = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    float tap = cs[t * (DEG + 1)];
#pragma unroll
    for (int d = 1; d <= DEG; ++d)
      tap = __fadd_rn(__fmul_rn(tap, uu), cs[t * (DEG + 1) + d]);
    const long idx = base + t;
    const float2 v = (idx >= 0 && idx < n2) ? yc[idx] : make_float2(0.f, 0.f);
    re = __fadd_rn(re, __fmul_rn(tap, v.x));
    im = __fadd_rn(im, __fmul_rn(tap, v.y));
  }
  out[(size_t)c * S + k] = make_float2(re, im);
}

}  // namespace

// y [C, n2] complex64 (interleaved float2), u [C, nt*TS] float32,
// rb [C, nt] int32, coef [TAPS, DEG+1] float32 -> out [C, S] complex64.
// Returns cudaGetLastError() after the launch.
extern "C" int resample_farrow(void* y, int C, int n2, void* u, void* rb,
                               int S, int nt, int bias, void* coef,
                               void* out, void* stream) {
  dim3 grid(nt, C);
  farrow_kernel<<<grid, TS, 0, (cudaStream_t)stream>>>(
      (const float2*)y, n2, (const float*)u, (const int*)rb, S, nt, bias,
      (const float*)coef, (float2*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* dvbs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
