// Soft demapper: every symbol's m LLRs in one pass, for a constellation of
// M = 2^m points (QPSK, 8PSK, 16APSK, 32APSK: M = 4, 8, 16, 32).
//
// Replaces no TPU kernel: dvbs_tpu/ops/demap.py is plain jnp, which XLA
// fuses on the TPU. Its plain PyTorch version (ops/demap.soft_demap_plain)
// runs unfused on the card: two [..., m, M] masked tensors, one per
// subset, each through where, amax, a subtraction, exp, sum and log, about
// 30 launches and 15 GB of device-memory traffic for the 32APSK bank's
// 1.66 M symbols a step (13.4 ms on an H100). Per symbol x, with the
// points already scaled on the host (p_s = pts[s] ps):
//
//   z_s    = -|x ss - p_s| / npwr                      s = 0 .. M-1
//   lse_kb = max_kb + log(sum over s in S_kb of exp(z_s - max_kb))
//   llr_k  = clamp((lse_k0 - lse_k1) sca)
//
// where S_kb holds the points whose bit k, (s >> (m-1-k)) & 1, is b
// (tables.demap_tables' mask0; the wrapper checks that it is given that
// pattern) and max_kb is the largest z over S_kb. Each subset takes its
// own maximum: with one maximum for both, a far subset's exps all
// underflow to 0 and its log to -inf. clamp halves until |llr| <= 127
// (x 2^-ceil(log2(|x| / 127)) for |x| > 127), the reference's int8 clamp;
// the count of halvings is taken exactly from frexpf, where the plain
// version takes a float log2. Positive = bit 0.
//
// The arithmetic is the plain version's, in float32 with the accurate
// expf, logf and sqrtf (no fast-math intrinsics), the sums taken point by
// point in order; it differs from the plain version's in rounding (the
// library's reduction order, hypot against sqrt of a fused square sum).
//
// What bounds it on the H100: instruction issue and the special-function
// unit, not bytes. A 32APSK symbol reads 8 B and writes 20 B, and takes
// 32 square roots, 160 exps and 10 logs (each an SFU operation and about
// ten FP32 instructions around it): ~2,300 instructions a symbol against
// 28 B. What the design does about it:
//   - a thread a symbol, the M distances in registers, the subsets'
//     masks known at compile time (a template per M, fully unrolled), so
//     no symbol's z goes through memory and no mask is read;
//   - the scaled points, the sample scale, the LLR scale and 1/npwr are
//     launch parameters (constant bank): each enters its instruction as
//     an operand, no load;
//   - the LLRs go out through shared memory, so a CTA's m x 256 floats
//     leave in coalesced 128-byte rows rather than m-strided stores.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;          // symbols a CTA

template <int M>
struct Points {
  float2 p[M];                        // pts * ps, interleaved re, im
};

__host__ __device__ constexpr int log2i(int M) {
  return M <= 1 ? 0 : 1 + log2i(M / 2);
}

// x 2^-ceil(log2(|x| / 127)) where |x| > 127: the least halvings that
// bring |x| to 127 or under, counted exactly (r = f 2^e with f in
// [0.5, 1): ceil(log2 r) is e - 1 where f is 0.5, else e)
__device__ __forceinline__ float clamp_halving(float x) {
  const float r = fabsf(x) / 127.f;
  if (!(r > 1.f)) return x;
  int e;
  const float f = frexpf(r, &e);
  return ldexpf(x, f == 0.5f ? 1 - e : -e);
}

template <int M>
__global__ void __launch_bounds__(THREADS)
soft_demap_kernel(const float2* __restrict__ syms, int n, const Points<M> pt,
                  float ss, float sca, float inv_npwr,
                  float* __restrict__ llr) {
  constexpr int m = log2i(M);
  __shared__ float stage[THREADS * m];
  const int base = blockIdx.x * THREADS;
  const int i = base + threadIdx.x;
  if (i < n) {
    const float2 v = syms[i];
    const float xr = v.x * ss, xi = v.y * ss;
    float z[M];
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const float dr = xr - pt.p[s].x, di = xi - pt.p[s].y;
      z[s] = -sqrtf(dr * dr + di * di) * inv_npwr;
    }
#pragma unroll
    for (int k = 0; k < m; ++k) {
      const int sh = m - 1 - k;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const int b = (s >> sh) & 1;
        mx[b] = fmaxf(mx[b], z[s]);
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const int b = (s >> sh) & 1;
        sum[b] += expf(z[s] - mx[b]);
      }
      const float d = (logf(sum[0]) + mx[0]) - (logf(sum[1]) + mx[1]);
      stage[threadIdx.x * m + k] = clamp_halving(d * sca);
    }
  }
  __syncthreads();
  const int count = min(THREADS, n - base) * m;
  float* out = llr + (size_t)base * m;
  for (int j = threadIdx.x; j < count; j += THREADS) out[j] = stage[j];
}

template <int M>
int launch(const void* syms, int n, const void* pts, float ss, float sca,
           float inv_npwr, void* llr, cudaStream_t stream) {
  Points<M> pt;
  memcpy(pt.p, pts, sizeof pt.p);
  const int grid = (n + THREADS - 1) / THREADS;
  soft_demap_kernel<M><<<grid, THREADS, 0, stream>>>(
      (const float2*)syms, n, pt, ss, sca, inv_npwr, (float*)llr);
  return (int)cudaGetLastError();
}

}  // namespace

// syms [n] complex64 (interleaved float2), pts the host's M scaled points
// (pts * ps, complex64), the sample scale ss, the LLR scale sca and
// 1/npwr -> llr [n, log2 M] float32. M is 4, 8, 16 or 32. Returns
// cudaGetLastError() after the launch.
extern "C" int soft_demap(void* syms, int n, int M, const void* pts,
                          float ss, float sca, float inv_npwr, void* llr,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (M) {
    case 4: return launch<4>(syms, n, pts, ss, sca, inv_npwr, llr, st);
    case 8: return launch<8>(syms, n, pts, ss, sca, inv_npwr, llr, st);
    case 16: return launch<16>(syms, n, pts, ss, sca, inv_npwr, llr, st);
    case 32: return launch<32>(syms, n, pts, ss, sca, inv_npwr, llr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
