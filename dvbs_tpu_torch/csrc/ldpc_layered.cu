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
// row (360), one launch per decode call: the block stages the frame's
// LLRs from codeword order into the posterior's layout, runs the
// sweeps, and writes the hard bits back in codeword order. The frame's
// posterior, (G+q)*360 int8 (63.3 KB for the normal-frame codes), and
// the layer schedule (an address pair an entry, a set of masks a layer)
// stay in shared memory for the call. Messages stay in global memory
// (33 MB for 128 B4 frames, inside the 50 MB L2), four entries to a
// 32-bit word, [q, ceil(Dmax/4), 360] words a frame, so a thread reads
// and writes its row's messages of a layer as ceil(Dmax/4) coalesced
// words; sweep 0 reads none. The early exit is the TPU kernel's, per
// call: sweeps go on until every frame has had a clean one. The blocks
// agree on that after each sweep through one counter in global memory,
// so with early exit the launch is cooperative (every block resident;
// 128 frames fit the 132 SMs).
//
// What bounds it: the integer instructions a thread issues per edge
// (about 23 on the ALU pipe, which the card has at half the float rate,
// 38 in all), with 12 warps an SM, so a sweep costs the same at 3 frames
// as at 128; before that, the chain of dependent steps and barriers of a
// layer. The bytes (int8 LLRs in, hard bits out) take microseconds.
// What the design does about it:
//   - the kernel is compiled once per entry count Dmax (13 values over
//     the 21 codes), so both passes unroll: every load of a layer is in
//     flight at once, and a layer's rolled posteriors and addresses stay
//     in registers from pass 1 to pass 2 (each message is read once);
//   - the next layer's message words are loaded a layer ahead, their
//     addresses depending on nothing computed;
//   - barriers only where the schedule demands them. A thread meets
//     another at a posterior address only where a group is touched at
//     two different shifts: at one shift the same thread returns to its
//     own address. So a layer whose groups all differ needs no barrier
//     between its passes, and starts behind one only if a group of it
//     was touched at another shift since the last barrier (F_BAR). A
//     layer with a repeated group (F_SYNC on the later entry) has a
//     barrier after pass 1 and one before that entry's update, since
//     saturation makes the order of two updates of one address matter.
//     B4: 52 barriers a sweep where a barrier per entry made 720;
//   - no arg-min: parities are the sign of a running xor, the two minima
//     come from min and max alone, and an entry takes m2 where its
//     magnitude equals m1 (a tie makes m2 == m1), which gives the TPU
//     kernel's first-index arg-min's values; bytes are extracted and
//     packed by byte permutes;
//   - the unsatisfied checks are summed by warp shuffle, one shared
//     atomic a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 360;
constexpr int BIG = 16384;      // "no edge" magnitude
constexpr int MSG_CLIP = 31;
// schedule word (tables.pack_schedule): g | s << 8 | flags << 17
constexpr int F_VALID = 1;
constexpr int F_MASK0 = 2;
constexpr int F_SYNC = 4;
constexpr int F_BAR = 8;

// sign-extended byte K of a packed message word: one byte permute
// (selector nibble K | 8 fills a byte with byte K's sign)
template <int K>
__device__ __forceinline__ int msg_byte(int w) {
  int d;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(w), "r"(0), "r"(K | (K | 8) << 4 | (K | 8) << 8 | (K | 8) << 12));
  return d;
}

// word with its byte K replaced by the low byte of m
template <int K>
__device__ __forceinline__ int put_byte(int word, int m) {
  return (int)__byte_perm((unsigned)word, (unsigned)m,
                          0x3210u ^ ((4u ^ K) << (4 * K)));
}

// One layer of one row. IRREG: the layer has a padding entry or the
// masked wrap edge; all other layers (nearly all) take the path
// without those tests. What the arithmetic rests on:
//   - parities as the sign of a running xor (of v, of the posteriors);
//   - the two minima by min and max alone, no index: the message of an
//     entry excludes its own magnitude, so it takes m2 where its
//     magnitude equals m1, else m1, and where two entries tie at the
//     minimum m2 == m1 makes the choice indifferent (the TPU kernel's
//     first-index arg-min gives the same values);
//   - both clipped magnitudes once a layer.
// Returns the parity of the row's posterior signs (1: check unsatisfied).
template <int D, bool IRREG>
__device__ __forceinline__ int layer(int8_t* sp, const int2* ent,
                                     const int4 lm,
                                     const int (&cur)[(D + 3) / 4],
                                     int (&out)[(D + 3) / 4], int i,
                                     int i_wrap, int beta) {
  // pass 1: v = rolled posterior - old message, from the pre-layer
  // posterior
  int m1 = BIG, m2 = BIG, vx = 0, px = 0;
  unsigned offm = 0u;                     // entries this row leaves out
  int v[D], addr[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    const int2 en = ent[e];               // address base, shift
    addr[e] = en.x + (i < en.y ? i : i_wrap);
    const int rolled = sp[addr[e]];
    v[e] = rolled - (e % 4 == 0   ? msg_byte<0>(cur[e / 4])
                     : e % 4 == 1 ? msg_byte<1>(cur[e / 4])
                     : e % 4 == 2 ? msg_byte<2>(cur[e / 4])
                                  : msg_byte<3>(cur[e / 4]));
    int a = abs(v[e]);
    if (IRREG) {
      const bool off = !((lm.y >> e) & 1) || (((lm.z >> e) & 1) && i == 0);
      offm |= (unsigned)off << e;
      a = off ? BIG : a;
      vx ^= off ? 0 : v[e];
      px ^= off ? 0 : rolled;
    } else {
      vx ^= v[e];
      px ^= rolled;
    }
    m2 = min(m2, max(m1, a));
    m1 = min(m1, a);
  }
  // where every group of the layer occurs once, no other row touches
  // this row's addresses: pass 2 may follow at once
  if (lm.x) __syncthreads();

  // pass 2: new messages, then the posterior update of each entry. An
  // entry's address still holds what pass 1 read unless an earlier
  // entry of the layer updated its group (F_SYNC): only then it is
  // read again, behind a barrier, so that the updates of one address
  // saturate in entry order.
  const int mag1 = min(max(m1 - beta, 0), MSG_CLIP);
  const int mag2 = min(max(m2 - beta, 0), MSG_CLIP);
#pragma unroll
  for (int w = 0; w < (D + 3) / 4; ++w) out[w] = 0;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    const bool off = IRREG && ((offm >> e) & 1u);
    const int a = off ? BIG : abs(v[e]);
    const int mag = a == m1 ? mag2 : mag1;
    const int sgn = (v[e] ^ vx) >> 31;    // layer parity xor own sign
    int news = off ? 0 : (mag ^ sgn) - sgn;
    const int old = e % 4 == 0   ? msg_byte<0>(cur[e / 4])
                    : e % 4 == 1 ? msg_byte<1>(cur[e / 4])
                    : e % 4 == 2 ? msg_byte<2>(cur[e / 4])
                                 : msg_byte<3>(cur[e / 4]);
    if (old != 0 && ((old ^ news) < 0)) news = 0;
    out[e / 4] = e % 4 == 0   ? put_byte<0>(out[e / 4], news)
                 : e % 4 == 1 ? put_byte<1>(out[e / 4], news)
                 : e % 4 == 2 ? put_byte<2>(out[e / 4], news)
                              : put_byte<3>(out[e / 4], news);
    if (!IRREG || ((lm.y >> e) & 1)) {    // padding entries update nothing
      int p;
      if ((lm.x >> e) & 1) {
        __syncthreads();
        p = sp[addr[e]] + (news - old);
      } else {
        p = v[e] + news;
      }
      sp[addr[e]] = (int8_t)min(max(p, -127), 127);
    }
  }
  return (int)((unsigned)px >> 31);
}

// Block-wide agreement on whether any frame of the call is still open
// after a sweep, for thread 0 of each block of a cooperative launch
// (every block resident): arrivals count in the low half of *word,
// open frames in the high half. Returns the open frames.
__device__ __forceinline__ int all_blocks_open(int* word, int open,
                                               int nblocks) {
  atomicAdd(word, 1 + (open << 16));
  int v;
  while (((v = *reinterpret_cast<volatile int*>(word)) & 0xffff) < nblocks)
    __nanosleep(32);
  return v >> 16;
}

template <int D>
__global__ void __launch_bounds__(LANES)
decode_kernel(const int8_t* __restrict__ llr, uint8_t* __restrict__ hard,
              int* __restrict__ msgs, const int* __restrict__ sched, int G,
              int q, int beta, int n_iters, int early_exit,
              int* __restrict__ trials, int* __restrict__ n_bad,
              int* __restrict__ sweep_sync) {
  constexpr int W = (D + 3) / 4;          // message words a row and layer

  // the posterior; per layer the masks {F_SYNC entries, F_VALID
  // entries, F_MASK0 entries, 1: irregular | 2: F_BAR}; per entry
  // {g*360 + 360 - s, s}, so that row i's rolled element is at the
  // base + (i < s ? i : i - 360)
  extern __shared__ __align__(16) int8_t sp[];
  __shared__ int total, go_on;
  const int b = blockIdx.x;
  const int i = threadIdx.x;              // circulant row
  const int K = G * LANES, P = q * LANES; // info and parity bits, N = K + P
  const int npost = K + P;                // a multiple of 8
  int4* lmask = reinterpret_cast<int4*>(sp + ((npost + 15) & ~15));
  int2* ent = reinterpret_cast<int2*>(lmask + q);
  int* gmsg = msgs + (size_t)b * q * W * LANES + i;

  // the frame's LLRs into the posterior's layout, 8 bytes a load: info
  // bit n at n, parity bit a = r + q*c at (G + r)*360 + c
  const int2* src8 = reinterpret_cast<const int2*>(llr + (size_t)b * npost);
  int2* sp8 = reinterpret_cast<int2*>(sp);
  for (int k = i; k < K / 8; k += LANES) sp8[k] = src8[k];
  for (int k = i; k < P / 8; k += LANES) {
    const int2 v = src8[K / 8 + k];
    int c = 8 * k / q, r = 8 * k - c * q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sp[K + r * LANES + c] = (int8_t)((j < 4 ? v.x : v.y) >> (8 * (j & 3)));
      if (++r == q) {
        r = 0;
        ++c;
      }
    }
  }
  for (int k = i; k < q * D; k += LANES) {
    const int sw = sched[k];
    const int g = sw & 0xff, s = (sw >> 8) & 0x1ff;
    ent[k] = make_int2(g * LANES + LANES - s, s);
  }
  if (i < q) {
    int4 lm = make_int4(0, 0, 0, 0);
    for (int e = 0; e < D; ++e) {
      const int fl = sched[i * D + e] >> 17;
      lm.x |= ((fl / F_SYNC) & 1) << e;
      lm.y |= ((fl / F_VALID) & 1) << e;
      lm.z |= ((fl / F_MASK0) & 1) << e;
      lm.w |= e == 0 && (fl & F_BAR) ? 2 : 0;
    }
    lm.w |= lm.z != 0 || lm.y != (int)((1ull << D) - 1);
    lmask[i] = lm;
  }
  if (i == 0) total = 0;
  __syncthreads();

  const int i_wrap = i - LANES;
  const unsigned lanes = i >= (LANES & ~31) ? (1u << (LANES & 31)) - 1u
                                            : 0xffffffffu;
  // thread 0's: the frame's first clean sweep and last count
  int my_trials = n_iters, my_bad = 1;
  bool my_done = false;
  for (int it = 0; it < n_iters; ++it) {
    // sweep 0 meets no messages; later sweeps ask for a layer's words a
    // layer ahead
    int cur[W];
#pragma unroll
    for (int w = 0; w < W; ++w) cur[w] = it ? __ldcg(gmsg + w * LANES) : 0;
    int bad = 0;
    for (int r = 0; r < q; ++r) {
      int nxt[W];
      const int rn = r + 1 < q ? r + 1 : r;
#pragma unroll
      for (int w = 0; w < W; ++w)
        nxt[w] = it ? __ldcg(gmsg + (rn * W + w) * LANES) : 0;
      const int4 lm = lmask[r];
      if (lm.w & 2) __syncthreads();      // F_BAR: see the header
      int out[W];
      if (lm.w & 1)
        bad += layer<D, true>(sp, ent + r * D, lm, cur, out, i, i_wrap, beta);
      else
        bad += layer<D, false>(sp, ent + r * D, lm, cur, out, i, i_wrap, beta);
#pragma unroll
      for (int w = 0; w < W; ++w) __stcg(gmsg + (r * W + w) * LANES, out[w]);
#pragma unroll
      for (int w = 0; w < W; ++w) cur[w] = nxt[w];
    }

    // the sweep's unsatisfied-check count over all rows and layers (the
    // last warp has 360 - 352 live lanes), then the call's verdict:
    // sweeps go on until every frame of the call has had a clean one
    const int wsum = __reduce_add_sync(lanes, bad);
    if ((i & 31) == 0 && wsum) atomicAdd(&total, wsum);
    __syncthreads();
    if (i == 0) {
      my_bad = total;
      total = 0;
      if (!my_done && my_bad == 0) {
        my_trials = it + 1;
        my_done = true;
      }
      go_on = !early_exit || it + 1 == n_iters ||
              all_blocks_open(sweep_sync + it, !my_done, gridDim.x) != 0;
    }
    __syncthreads();                      // also the next sweep's first barrier
    if (!go_on) break;
  }
  if (i == 0) {
    n_bad[b] = my_bad;
    trials[b] = my_trials;
  }

  // hard bits in codeword order: the sign bit of each posterior byte
  int2* dst8 = reinterpret_cast<int2*>(hard + (size_t)b * npost);
  for (int k = i; k < K / 8; k += LANES) {
    const int2 v = sp8[k];
    dst8[k] = make_int2((v.x >> 7) & 0x01010101, (v.y >> 7) & 0x01010101);
  }
  for (int k = i; k < P / 8; k += LANES) {
    int c = 8 * k / q, r = 8 * k - c * q;
    unsigned h[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j >> 2] |= (unsigned)(sp[K + r * LANES + c] < 0) << (8 * (j & 3));
      if (++r == q) {
        r = 0;
        ++c;
      }
    }
    dst8[K / 8 + k] = make_int2((int)h[0], (int)h[1]);
  }
}

// shared memory of a block: the posterior (rounded up to 16 bytes), a
// mask word set a layer, an address pair an entry
inline int decode_smem(int NG, int q, int D) {
  return ((NG * LANES + 15) & ~15) + q * (int)sizeof(int4) +
         q * D * (int)sizeof(int2);
}

struct DecodeArgs {
  const int8_t* llr;
  uint8_t* hard;
  int* msgs;
  const int* sched;
  int B, G, q, beta, n_iters, early_exit;
  int *trials, *n_bad, *sweep_sync;
  cudaStream_t stream;
};

// With early exit the blocks agree after every sweep, so all of them
// must be resident: a cooperative launch, which fails when they cannot
// be (cudaErrorCooperativeLaunchTooLarge) rather than hang. Without,
// blocks are independent. The shared-memory limit is raised once a
// process and size: one device a process.
template <int D>
int launch_decode(DecodeArgs a) {
  static int smem_set = 0;                // largest size asked for so far
  const int smem = decode_smem(a.G + a.q, a.q, D);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (a.early_exit) {
    void* args[] = {&a.llr,   &a.hard,    &a.msgs,       &a.sched,
                    &a.G,     &a.q,       &a.beta,       &a.n_iters,
                    &a.early_exit, &a.trials, &a.n_bad,  &a.sweep_sync};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)decode_kernel<D>, dim3(a.B), dim3(LANES), args, smem,
        a.stream);
    if (err != cudaSuccess) cudaGetLastError();   // reported here, so cleared
    return (int)err;
  }
  decode_kernel<D><<<a.B, LANES, smem, a.stream>>>(
      a.llr, a.hard, a.msgs, a.sched, a.G, a.q, a.beta, a.n_iters,
      a.early_exit, a.trials, a.n_bad, a.sweep_sync);
  return (int)cudaGetLastError();
}

}  // namespace

// A whole decode call over B frames, up to n_iters sweeps in one launch:
// llr [B, N] int8 in codeword order -> hard [B, N] uint8, trials and
// n_bad [B] int32. msgs [B, q, ceil(Dmax/4), 360] int32 is scratch (four
// int8 messages a word; need not be cleared), sched [q, Dmax] int32 the
// packed schedule, sweep_sync [n_iters] int32 zeros. Dmax must be one of
// the entry counts the kernel is compiled for (those of the DVB-S2
// codes). Returns the launch's error code.
extern "C" int ldpc_layered_decode(void* llr, void* hard, void* msgs,
                                   void* sched, int B, int G, int q, int Dmax,
                                   int beta, int n_iters, int early_exit,
                                   void* trials, void* n_bad,
                                   void* sweep_sync, void* stream) {
  const DecodeArgs a = {(const int8_t*)llr, (uint8_t*)hard, (int*)msgs,
                        (const int*)sched, B, G, q, beta, n_iters, early_exit,
                        (int*)trials, (int*)n_bad, (int*)sweep_sync,
                        (cudaStream_t)stream};
  switch (Dmax) {
    case 4: return launch_decode<4>(a);
    case 5: return launch_decode<5>(a);
    case 6: return launch_decode<6>(a);
    case 7: return launch_decode<7>(a);
    case 10: return launch_decode<10>(a);
    case 11: return launch_decode<11>(a);
    case 13: return launch_decode<13>(a);
    case 14: return launch_decode<14>(a);
    case 18: return launch_decode<18>(a);
    case 19: return launch_decode<19>(a);
    case 22: return launch_decode<22>(a);
    case 27: return launch_decode<27>(a);
    case 30: return launch_decode<30>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
