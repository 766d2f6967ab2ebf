// Layered offset-min-sum decoder for the DVB-S2 QC-LDPC codes, int8.
//
// Replaces the Pallas TPU kernel of dvbs_tpu/ops/ldpc_pallas.py
// (_kernel / _layer_body, launched by pl.pallas_call in
// _decode_qc_pallas) and computes what it computes, bit for bit:
// per layer a two-min over the entries (info groups rolled by their
// shift, the layer's parity group, the previous parity group with the
// wrap edge of layer 0 masked), message magnitude clip(excl_min - beta,
// 0, 31), sign = layer parity xor own sign, a message whose sign
// flipped is zeroed, and a saturating int8 posterior update applied
// entry by entry. Each sweep also counts the frame's unsatisfied checks
// online (the parity of the pre-update posterior signs per check row).
//
// Layout on Hopper: one CUDA block per frame, one thread per circulant
// row (360). The frame's posterior, (G+q)*360 int8 (63.3 KB for the
// normal-frame codes), stays in shared memory for the sweep; messages,
// q*Dmax*360 int8 per frame (29 MB for 128 B4 frames), stay in global
// memory and fit the 50 MB L2. One launch is one sweep. The host
// enqueues n_iters launches and never waits: a launch returns at once
// when the previous sweep left no frame open (open_after[it-1] == 0),
// which is the batch-granular early exit of the TPU kernel's while loop.
//
// What bounds it: not bytes (a sweep moves ~3 message bytes per edge
// through L2) but latency. Each layer is a chain of dependent steps
// (pass 1 over Dmax entries, a barrier, Dmax read-modify-writes each
// followed by a barrier), and 128 frames fill only 128 of the 132 SMs
// with one 12-warp block each. Overlapping layers, or several frames per
// block, is work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 360;
constexpr int MAXD = 32;        // largest Dmax of any DVB-S2 code is 30
constexpr int BIG = 16384;      // "no edge" magnitude
constexpr int MSG_CLIP = 31;
constexpr int F_VALID = 1;
constexpr int F_MASK0 = 2;

__global__ void __launch_bounds__(LANES)
sweep_kernel(int8_t* __restrict__ post, int8_t* __restrict__ msgs,
             const int* __restrict__ g_tab, const int* __restrict__ s_tab,
             const int* __restrict__ f_tab, int NG, int q, int Dmax,
             int beta, int it, int early_exit, int* __restrict__ trials,
             int* __restrict__ done, int* __restrict__ n_bad,
             int* __restrict__ open_after) {
  if (early_exit && it > 0 && open_after[it - 1] == 0) return;

  extern __shared__ int8_t sp[];          // this frame's posterior
  __shared__ int total;
  const int b = blockIdx.x;
  const int i = threadIdx.x;              // circulant row
  const int npost = NG * LANES;
  int8_t* gpost = post + (size_t)b * npost;
  int8_t* gmsg = msgs + (size_t)b * q * Dmax * LANES;

  // npost is a multiple of 360, so whole 32-bit words
  const int* src4 = reinterpret_cast<const int*>(gpost);
  int* sp4 = reinterpret_cast<int*>(sp);
  for (int k = i; k < npost / 4; k += LANES) sp4[k] = src4[k];
  __syncthreads();

  int bad = 0;
  for (int r = 0; r < q; ++r) {
    const int* gr = g_tab + r * Dmax;
    const int* sr = s_tab + r * Dmax;
    const int* fr = f_tab + r * Dmax;
    int8_t* mr = gmsg + (size_t)r * Dmax * LANES;

    // pass 1: v = rolled posterior - old message, running two-min,
    // parities of v and of the posterior signs, all from the pre-layer
    // posterior
    int m1 = BIG, m2 = BIG, am = 0, par = 0, pxor = 0;
    unsigned negv = 0u;                   // raw sign(v) per entry
    for (int e = 0; e < Dmax; ++e) {
      const int g = gr[e], s = sr[e], fl = fr[e];
      int idx = i - s;
      if (idx < 0) idx += LANES;
      const int rolled = sp[g * LANES + idx];
      const int old = mr[e * LANES + i];
      const int v = rolled - old;
      if (v < 0) negv |= 1u << e;
      int a = v < 0 ? -v : v;
      int neg = v < 0;
      int pneg = rolled < 0;
      if (!(fl & F_VALID) || ((fl & F_MASK0) && i == 0)) {
        a = BIG;
        neg = 0;
        pneg = 0;
      }
      if (e == 0) {
        m1 = a;
        par = neg;
        pxor = pneg;
      } else {
        const bool isnew = a < m1;
        m2 = isnew ? m1 : min(m2, a);
        m1 = isnew ? a : m1;
        am = isnew ? e : am;
        par ^= neg;
        pxor ^= pneg;
      }
    }
    bad += pxor;
    __syncthreads();

    // pass 2: new messages, then the posterior update of each entry in
    // order e = 0..Dmax-1 (a group twice in one layer accumulates)
    for (int e = 0; e < Dmax; ++e) {
      const int g = gr[e], s = sr[e], fl = fr[e];
      const int excl = (am == e) ? m2 : m1;
      const int mag = min(max(excl - beta, 0), MSG_CLIP);
      int news = ((par ^ ((negv >> e) & 1u)) != 0) ? -mag : mag;
      if (!(fl & F_VALID) || ((fl & F_MASK0) && i == 0)) news = 0;
      const int old = mr[e * LANES + i];
      if (old != 0 && ((old ^ news) < 0)) news = 0;
      mr[e * LANES + i] = (int8_t)news;
      int idx = i - s;
      if (idx < 0) idx += LANES;
      const int p = sp[g * LANES + idx] + (news - old);
      sp[g * LANES + idx] = (int8_t)min(max(p, -127), 127);
      __syncthreads();
    }
  }

  // the sweep's unsatisfied-check count over all rows and layers (the
  // last warp is partial, so a shared-memory sum, not warp shuffles)
  if (i == 0) total = 0;
  __syncthreads();
  if (bad) atomicAdd(&total, bad);
  __syncthreads();
  if (i == 0) {
    n_bad[b] = total;
    if (!done[b] && total == 0) {
      trials[b] = it + 1;
      done[b] = 1;
    }
    if (!done[b]) atomicAdd(&open_after[it], 1);
  }
  int* dst4 = reinterpret_cast<int*>(gpost);
  for (int k = i; k < npost / 4; k += LANES) dst4[k] = sp4[k];
}

}  // namespace

// One layered sweep over B frames. post [B, NG, 360] int8 and
// msgs [B, q, Dmax, 360] int8 are updated in place; trials, done,
// n_bad [B] int32 and open_after [n_iters] int32 carry the sweep loop.
// Returns cudaGetLastError() after the launch.
extern "C" int ldpc_layered_sweep(void* post, void* msgs, void* g_tab,
                                  void* s_tab, void* f_tab, int B, int NG,
                                  int q, int Dmax, int beta, int it,
                                  int early_exit, void* trials, void* done,
                                  void* n_bad, void* open_after,
                                  void* stream) {
  if (Dmax > MAXD) return (int)cudaErrorInvalidValue;
  const int smem = NG * LANES;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<<<B, LANES, smem, (cudaStream_t)stream>>>(
      (int8_t*)post, (int8_t*)msgs, (const int*)g_tab, (const int*)s_tab,
      (const int*)f_tab, NG, q, Dmax, beta, it, early_exit, (int*)trials,
      (int*)done, (int*)n_bad, (int*)open_after);
  return (int)cudaGetLastError();
}
