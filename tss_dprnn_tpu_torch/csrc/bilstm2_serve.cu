// The LSTM serving scan for Hopper (sm_90a), fp32 and bf16 streams: the
// recurrence with W_hh resident in the shared memory of a 2-CTA cluster and
// h @ W_hh on the tensor cores (fp32: 3xTF32; bf16: one bf16 mma). Its mode 3
// is the bf16 training forward, its mode 4 the cell-state forward (below).
//
// Replaces four TPU kernels in their inference modes, both stream types:
// - `_bilstm2_kernel` (tss_dprnn_tpu/ops/pallas_lstm.py:698) unmasked and
//   masked (`bilstm2_forward` :935, `bilstm2_forward_masked` :949), the modes
//   every fused bidirectional serving scan runs, and the scan of its dense
//   mode (`bilstm2_dense_forward` :969): the outputs side by side into a
//   scratch that the SplitDense products of csrc/products.cu read
//   (ops/bilstm2.py), where the TPU kernel runs h @ wo in its epilogue;
// - `_lstm_kernel` (:57, launched by _pallas_core :231) in its h-only mode
//   (`lstm_forward`): D stacked directions, each on its own input in forward
//   time, the causal DPRNN's inter-chunk scan; and in its `reverse_dir1`
//   mode (`bilstm_pallas_fused` :171): the pair on one shared x, direction 1
//   reversed, the outputs side by side (out_step 2H); and in its `want_cs`
//   mode (`lstm_forward_with_cs`, mode 4 below);
// - `_bilstm2_bm_kernel` (:1088, launched by bilstm2_forward_bm :1193): the
//   pair's unmasked function in the batch-major layout, which the port uses
//   throughout (ops/bilstm2.bilstm2_forward_bm); the TPU entry pads T to its
//   8-step blocks and holds direction 1 on the pad steps, the same function
//   as a scan from T-1;
// - `_lstm_manual_kernel` (:275, launched by _pallas_core_v2 :373): the
//   stack (`lstm_scan_pallas_v2` :418) and the pair on one shared x with its
//   outputs side by side (`bilstm_pallas_v2` :402, out_step 2H), with the
//   cell update of dtype 2 in bf16 (below).
// As in the training forward (bilstm2_resid.cu), the input product P of every
// row-step runs first, in csrc/products.cu: x @ [W_ih[0] | W_ih[1]] + b into
// one buffer [R, T, 2, 4H] for the pair, x[d] @ W_ih[d] + b[d] into
// [D, R, T, 4H] for the stack (ScanArgs says where a direction's gates lie).
// P is fp32 in both stream types (bf16 x is exact in the 3xTF32 product and
// in the bf16-operand product that the last two kernels' bf16 streams take,
// and the TPU kernels never round x_t @ W_ih before adding h @ W_hh). This
// kernel then runs, per direction d,
//   gates = P[d][:, t] + h @ W_hh[d]            (torch gate order i, f, g, o)
//   c = f * c + i * g;  h = round_to_stream_type(o * tanh(c))
// step by step (c in fp32, h fed back rounded, as pallas_lstm.py:765, :806)
// and writes only the outputs [R, T, H] in the stream type (no residual
// stream, nothing back into P). Direction 0 scans t = 0..T-1; direction 1 the
// same, or t = T-1..0 for the pair (`reverse1`). Masked (the pair only): the
// reversed direction holds its zero state while t >= len[row], so its output
// there is 0; the other's past a row's length is unspecified (finite), and
// steps past the tile's longest row write zeros.
//
// What bounds it: the operations of h @ W_hh, 2 H 4H FLOP per row-step and
// direction (fp32: three TF32 products per fp32 one), and the step-to-step
// dependency: all parallelism comes from rows and directions, and every step
// ends in a barrier.
//
// Design: one 2-CTA cluster per (direction, tile of 16 MT rows, MT = 1 or
// 2); the wrapper picks MT per stream type from the card's occupancy so that
// the grid takes the fewest waves (ops/bilstm2.plan_tiles). CTA c owns hidden
// units [c H/2, (c + 1) H/2) and keeps the gate columns of its units,
// W_hh[d][:, gate * H + unit] ([H][2H]: 128 KB fp32, 64 KB bf16 at H = 128),
// in shared memory for the whole scan, loaded once by bulk copies on an
// mbarrier, in the order the lanes read their B fragments (laid out by the
// host, ops/bilstm2.serve_weight_layout(_bf16)). h ([16 MT][H], both halves)
// lives in shared memory, double buffered as in the training forward: each
// CTA writes its half of the new h into buffer (s + 1) % 2 of both CTAs (the
// partner's through distributed shared memory), and one cluster barrier ends
// the step. A warp owns 8 hidden units of its CTA's half, all four of their
// gates, and one 16-row m-tile: its four n-tiles are gates i, f, g, o of
// those units, so a thread's accumulators hold all four gates of its (row,
// unit) pairs and the cell update needs no exchange; c stays in registers. A
// warp reads its own 32 columns of W each step, not all of W, and loads its
// m-tile of h by ldmatrix.
//
// fp32: mma.sync m16n8k8 tf32 in 3xTF32 (tf32_mma.cuh, as csrc/products.cu):
// each operand split into big + small TF32 values, and each 8-deep k-step's
// small*big + big*small + big*big into a fresh partial added to the sum in
// fp32 (round to nearest). W's split held in shared memory would take 256 KB,
// which a 2-CTA cluster cannot hold, so the B fragments are split as they are
// loaded ([k-step][unit group][lane][gate][2]: two 16-byte loads a lane); h is
// stored already split, its big and small TF32 parts loaded by one ldmatrix
// each. The four gates' chains of three mma are issued side by side.
// bf16: mma.sync m16n8k16 bf16 with fp32 accumulation, one mma per gate and
// 16-deep k-step. A bf16 product is exact in fp32, so this is what the TPU
// kernel's jnp.dot(h.astype(bf16), W_hh, preferred_element_type=f32)
// computes (pallas_lstm.py:754, :779) but for the order of the fp32 sums and
// the tensor cores' truncating accumulation, both far below a bf16 ulp of h.
// W in bf16 ([k-step][unit group][j][lane][gate][2]: a lane's fragments are
// two 16-byte loads, a warp's 32 lanes 512 contiguous bytes each) and h in
// bf16, one part, with no split of either.
//
// Registers and shared memory set the tile height. The accumulators of one
// m-tile per warp fit the 128 registers of a 512-thread CTA; the step's P
// slice comes into per-thread staging slots in shared memory by cp.async a
// step ahead, not into registers (P and the accumulators of 64 or 80 rows in
// registers spilled at 255 and left the mma chains latency-bound). fp32
// shared memory: 128 KB of W, 4 x 16 MT x (H + 4) x 4 B of h (two buffers of
// two parts) and 16 MT x 2H x 4 B of P: 226 KB at 32 rows, within the 227 KB
// a CTA may use; hence tiles of 16 or 32 rows. bf16: 64 KB of W, 2 x 16 MT x
// (H + 8) x 2 B of h, the same P slots: 88.5 KB at 16 rows, 113 KB at 32, so
// the occupancy query may find two 16-row CTAs on an SM.
//
// Modes (kMode), compiled apart so that the default route's kernels stay as
// they were: 0, the outputs [R, T, H] each and h the only rounded value (every
// default serving scan); 1, the outputs at a row-step stride out_step with
// h-only rounding (the two side by side: fp32 `bilstm_pallas_v2`, and both
// stream types of `bilstm_pallas_fused` and of the dense mode's scan); 2
// (bf16 streams, dtype 2), that
// stride and the manual-DMA kernel's rounding: its source computes in the
// stream type (pallas_lstm.py:334-340), so the cell update rounds to bf16 the
// gates round(P + h @ W_hh), each operation of the activations (the sigmoid's
// exp, 1 + and 1 /, each from rounded operands; tanh), i * g, tanh(c) and h,
// with c carried in fp32. fp32 streams round nowhere, so the manual-DMA
// kernel's fp32 entries run mode 0 or 1. Modes 1 and 2 take the shared memory
// and threads of mode 0, with registers capped at 128 by the launch bounds:
// the same occupancy (the bf16 query asks modes 0 and 1 and answers the
// smaller count, so one tile plan serves both). 3 (bf16 streams only,
// `bilstm2_serve_resid_scan`): the training forward's residual mode of
// `_bilstm2_kernel` (`want_resid` :982) and of `_lstm_kernel` (`want_resid`,
// `lstm_forward_resid`), which csrc/bilstm2_resid.cu runs in fp32: mode 0's
// arithmetic and rounding (h rounded to bf16 before it feeds the next step,
// c carried in fp32), and besides the outputs it writes the gate
// pre-activations P + h @ W_hh back into P in place (fp32; the backward
// reads its gates from them) and the residual streams, each [R, T, H] in
// bf16 at forward time t: h before the step (the bf16 h the step read), c
// before it and tanh(c) after it, both rounded there, so the backward reads
// the rounded cell states as the TPU kernel's does. Held steps of the
// masked reversed direction store h = c = 0 and the tanh(c) and gates that
// step computed (the backward skips them); steps past the tile's longest
// row write zeros into every stream and P. Mode 3 takes mode 0's shared
// memory and threads. 4 (fp32 and bf16 streams, `bilstm2_serve_cs_scan`):
// `_lstm_kernel`'s `want_cs` mode (pallas_lstm.py:113-114), the forward of
// `lstm_save_every`'s segment-checkpointed recurrence: mode 0's arithmetic
// and rounding, and besides the outputs the fp32 cell state after each step
// (c after its update) into cs[d], [R, T, H], at the outputs' offsets. It
// takes no lengths and reverses no direction. Mode 4 takes mode 0's shared
// memory and threads (the occupancy query answers the smaller count of the
// two).
//
// Layout (kTM): batch-major, every mode: row-step (r, t) of P, of the outputs
// and of the streams at (r * T + t) times its step; time-major (the JAX
// package's `*_tm` entries, pallas_lstm.py:1028-1056, 1213), modes 0 and 3
// only: at (t * R + r) times its step, so P is [T, R, 2, 4H] and the outputs
// [T, R, H]. Only the scan addresses by row-step; the input product, and the
// backward's products, run over all row-steps in either order. The layout is
// a template parameter, so the batch-major instantiations compile as they did
// (a larger ScanArgs moved their registers, see below).
//
// Accuracy: the 3xTF32 products keep about 22 mantissa bits (the product
// kernel's error against float64 is 1.2e-7 to 5.1e-7 of max |ref|,
// PERF.md), and the gate sums run in another order than the plain version's
// fp32 matmul; both are orders of magnitude below the 1e-4 absolute bar on
// h, which lies in (-1, 1). bf16 is held to its plain version at 70 dB and a
// bf16 ulp of h; dtype 2 at 55 dB, since its six roundings per unit and step
// flip wherever a gate summed in another order lands on the other side of a
// bf16 boundary (scripts/port/v2_bf16_floor.py). The summation order is
// fixed, with no atomics, so a run repeats itself bit for bit.

#include "cluster_scan.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace scan_common;
using namespace cluster_scan;
using namespace tf32_mma;

// h's parts in shared memory: fp32 its big and small TF32 values, bf16 one
template <typename S>
constexpr int kParts = kLowPrecision<S> ? 1 : 2;

// padded row pitch of the h tile, in elements of the stream type: rows 16
// bytes past a multiple of 128 put the 8 rows x 16 bytes of an ldmatrix phase
// on 32 banks
template <typename S>
__host__ __device__ constexpr int hs_pitch(int H) {
  return kLowPrecision<S> ? H + 8 : H + 4;
}

// shared memory of one CTA: W slice, two h buffers of kParts each, the P
// staging (16 floats per thread, 2H x MT threads) and the mbarrier
template <typename S>
constexpr size_t smem_bytes(int mt, int H) {
  return static_cast<size_t>(H) * 2 * H * sizeof(S) +
         static_cast<size_t>(2 * kParts<S> * 16 * mt * hs_pitch<S>(H)) * sizeof(S) +
         static_cast<size_t>(32 * mt * H) * sizeof(float) + sizeof(uint64_t);
}

// two values rounded to bf16, as one 32-bit store into a cluster peer's
// shared memory (4-byte aligned)
__device__ __forceinline__ void st2_cluster_bf16(unsigned addr, const float (&v)[2]) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&p))
               : "memory");
}

// Where the scan finds a direction's row-steps: gate column j of direction d
// at row-step (gr, t) is pre[d * pre_dir + (gr * Tn + t) * pre_step + j], unit
// u of its output out[d][(gr * Tn + t) * out_step + u]; time-major (kTM)
// (t * R + gr) in place of (gr * Tn + t). Direction 1 runs t =
// T-1..0 when `reverse1`, else t = 0..T-1 as direction 0 does. S is the
// stream type of W's fragments and the outputs. Mode 3's streams and mode
// 4's cell states lie as the outputs do (out_step H).
template <typename S>
struct ScanArgs {
  float* pre;  // P, read only; mode 3 overwrites it with the gate pre-activations
  // fp32: [dirs, 2 c, H / 8 ks, H / 16 w, 32 lanes, 4 gates, 2 j]
  // bf16: [dirs, 2 c, H / 16 ks, H / 16 w, 2 j, 32 lanes, 4 gates, 2 e]
  const S* wfrag;
  const int* lens;  // [R] or null
  S* out[2];
  // one slot for the two modes' first stream: a ScanArgs 16 bytes larger
  // moved the other modes' registers (fp32 mode 0 121 -> 124)
  union {
    S* hp[2];      // mode 3: h and c before each step, tanh(c) after it
    float* cs[2];  // mode 4: the cell state after each step, fp32
  };
  S* cp[2];
  S* tc[2];
  long long pre_dir;
  int pre_step;
  int out_step;  // elements between two row-steps of an output: H, or 2H side by side
  int reverse1;
  int R, Tn, H;
};

// Grid (2, tiles, dirs) in clusters of (2, 1, 1); 2H x MT threads: warp w
// owns the 8 units w % (H / 16) of its CTA's half and m-tile w / (H / 16)
// (rows 16 mt .. 16 mt + 15 of the tile). CTA (d, c)'s slice of wfrag is
// contiguous (see bilstm2_serve_scan).
// kMode (see the header): 0 outputs H apart, 1 out_step apart, 2 out_step
// apart with the manual-DMA TPU kernel's bf16 roundings, 3 mode 0 and the
// training forward's residual streams, 4 mode 0 and the cell state. kTM: the
// time-major layout (modes 0 and 3).
template <typename S, int MT, int kMode, bool kTM>
__global__ void __launch_bounds__(512, 1) serve_scan_kernel(const ScanArgs<S> a) {
  static_assert(kMode != 2 || kLowPrecision<S>, "fp32 streams round nowhere: no mode 2");
  static_assert(kMode != 3 || kLowPrecision<S>, "fp32 streams train on bilstm2_resid.cu");
  static_assert(!kTM || kMode == 0 || kMode == 3, "time-major: modes 0 and 3 only");
  constexpr bool kV2 = kMode == 2;
  constexpr bool kResid = kMode == 3;
  constexpr bool kCs = kMode == 4;
  constexpr int RT = 16 * MT;
  constexpr bool kLow = kLowPrecision<S>;
  constexpr int kP = kParts<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, Tn = a.Tn, H = a.H;
  const int* __restrict__ lens = a.lens;
  const int Hh = H / 2, ngroups = H / 16;
  const int hpitch = hs_pitch<S>(H);
  S* ws = reinterpret_cast<S*>(smem);                                // W slice in fragment order
  S* hs = ws + H * 2 * H;                                            // [2 buffers][kP][RT][hpitch]
  float* stg = reinterpret_cast<float*>(hs + 2 * kP * RT * hpitch);  // [8 slots][nthreads][2]
  uint64_t* bar = reinterpret_cast<uint64_t*>(stg + 32 * MT * H);

  const unsigned c = cluster_rank();
  const int d = blockIdx.z;
  const bool rev = d == 1 && a.reverse1;  // this direction scans t = T-1..0
  const int row0 = blockIdx.y * RT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int ug = warp % ngroups, mt = warp / ngroups;  // the warp's units and m-tile
  const int lg = lane >> 2, lt = lane & 3;  // the fragments' group and thread-in-group
  const int gu = c * Hh + 8 * ug + 2 * lt;  // this thread's two units, of all H

  load_resident(reinterpret_cast<float*>(ws),
                reinterpret_cast<const float*>(a.wfrag +
                                               (d * 2 + c) * static_cast<long long>(H) * 2 * H),
                static_cast<unsigned>(H * 2 * H * sizeof(S)), bar);

  // this thread's rows 16 mt + lg + 8 hh: their lengths, and the tile's
  // longest row (every thread reads them all)
  int rlen[2];
  int t_end = 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = row0 + 16 * mt + lg + 8 * hh;
    rlen[hh] = gr < R ? (lens != nullptr ? min(max(lens[gr], 0), Tn) : Tn) : 0;
  }
  for (int i = 0; i < RT && row0 + i < R; ++i)
    t_end = max(t_end, lens != nullptr ? min(max(lens[row0 + i], 0), Tn) : Tn);

  // selects, not a runtime index into the parameter array (which would copy
  // it to local memory)
  S* __restrict__ out = d == 0 ? a.out[0] : a.out[1];
  using PreT = std::conditional_t<kResid, float, const float>;  // written in mode 3 only
  PreT* __restrict__ pre = a.pre + d * a.pre_dir + gu;
  const int ostep = kMode == 0 || kResid || kCs ? H : a.out_step;
  auto out_at = [&](S* base, int gr, int t) {
    if constexpr (kTM) return base + (static_cast<long long>(t) * R + gr) * ostep + gu;
    else return base + static_cast<long long>(gr) * (Tn * ostep) + t * ostep + gu;
  };
  S* __restrict__ hpd = kResid ? (d == 0 ? a.hp[0] : a.hp[1]) : nullptr;
  S* __restrict__ cpd = kResid ? (d == 0 ? a.cp[0] : a.cp[1]) : nullptr;
  S* __restrict__ tcd = kResid ? (d == 0 ? a.tc[0] : a.tc[1]) : nullptr;
  float* __restrict__ csd = kCs ? (d == 0 ? a.cs[0] : a.cs[1]) : nullptr;
  auto pre_at = [&](int gr, int t) {
    if constexpr (kTM) return pre + (static_cast<long long>(t) * R + gr) * a.pre_step;
    else return pre + (static_cast<long long>(gr) * Tn + t) * a.pre_step;
  };

  const float zeros[2] = {0.f, 0.f};
  for (int t = t_end; t < Tn; ++t) {  // past every row's length
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = row0 + 16 * mt + lg + 8 * hh;
      if (gr < R) {
        st2(out_at(out, gr, t), zeros);
        if constexpr (kResid) {
          st2(out_at(hpd, gr, t), zeros);
          st2(out_at(cpd, gr, t), zeros);
          st2(out_at(tcd, gr, t), zeros);
#pragma unroll
          for (int g = 0; g < 4; ++g) st2(pre_at(gr, t) + g * H, zeros);
        }
      }
    }
  }

  // the step's P for this thread's (row, unit) pairs into its own staging
  // slots (hh * 4 + gate) by cp.async, a step ahead (no barrier needed: a
  // thread reads only what it copied)
  auto slot = [&](int hh, int g) { return stg + ((hh * 4 + g) * nthreads + tid) * 2; };
  auto stage = [&](int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = row0 + 16 * mt + lg + 8 * hh;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        cp_async8(slot(hh, g), gr < R ? pre_at(gr, t) + g * H : pre, gr < R);
    }
    cp_async_commit();
  };
  if (t_end > 0) stage(rev ? t_end - 1 : 0);
  for (int i = tid; i < kP * RT * hpitch; i += nthreads) hs[i] = from_f<S>(0.f);  // h = 0
  float cst[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  cluster_sync();     // both CTAs run, the mbarrier is initialised, h = 0 is in place
  mbar_wait(bar, 0);  // the W slice landed

  for (int s = 0; s < t_end; ++s) {
    const int t = rev ? t_end - 1 - s : s;
    // acc[g] = h @ W_hh[d] for the warp's m-tile and gate g of its units
    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
    const S* hb = hs + (s & 1) * kP * RT * hpitch;  // this step's h
    if constexpr (kLow) {
      // A fragments of k-step ks: rows 16 mt + (lane & 15), k 16 ks + 8 (lane >> 4)
      const S* ap = hb + (16 * mt + (lane & 15)) * hpitch + 8 * (lane >> 4);
      // this lane's B fragments of k-step ks: j = 0 at wl[ks * ngroups * 512
      // + 0..7], j = 1 256 further, gates 0..3 as bf16 pairs
      const S* wl = ws + ug * 512 + lane * 8;
#pragma unroll 2
      for (int ks = 0; ks < H / 16; ++ks) {
        const uint4 b0 = *reinterpret_cast<const uint4*>(wl + ks * ngroups * 512);
        const uint4 b1 = *reinterpret_cast<const uint4*>(wl + ks * ngroups * 512 + 256);
        uint32_t af[4];
        ldmatrix_x4_b16(af, ap + 16 * ks);
        mma_bf16(acc[0], af, b0.x, b1.x);
        mma_bf16(acc[1], af, b0.y, b1.y);
        mma_bf16(acc[2], af, b0.z, b1.z);
        mma_bf16(acc[3], af, b0.w, b1.w);
      }
    } else {
      // this lane's B fragments of k-step ks: wl[ks * ngroups * 256 + 0..7]
      const float* wl = ws + (ug * 32 + lane) * 8;
      // A fragments, split when h was written: rows 16 mt + (lane & 15), k
      // 8 ks + 4 (lane >> 4), the small part RT rows further
      const float* ap = hb + (16 * mt + (lane & 15)) * hpitch + 4 * (lane >> 4);
#pragma unroll 2
      for (int ks = 0; ks < H / 8; ++ks) {
        // B fragment of gate g: (k = 8 ks + lt, 8 ks + lt + 4; unit lg of the warp's 8)
        const float4 b01 = ld4(wl + ks * ngroups * 256);
        const float4 b23 = ld4(wl + ks * ngroups * 256 + 4);
        const float bv[4][2] = {{b01.x, b01.y}, {b01.z, b01.w}, {b23.x, b23.y}, {b23.z, b23.w}};
        uint32_t bbig[4][2], bsmall[4][2];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int j = 0; j < 2; ++j) split_tf32(bv[g][j], bbig[g][j], bsmall[g][j]);
        uint32_t abig[4], asmall[4];
        float av[4];
        ldmatrix_x4(av, ap + 8 * ks);
#pragma unroll
        for (int q = 0; q < 4; ++q) abig[q] = __float_as_uint(av[q]);
        ldmatrix_x4(av, ap + RT * hpitch + 8 * ks);
#pragma unroll
        for (int q = 0; q < 4; ++q) asmall[q] = __float_as_uint(av[q]);
        // per gate the small terms first, then big * big, into a fresh
        // partial added to the sum in round-to-nearest; the four gates'
        // chains are issued side by side
        float part[4][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) mma_tf32_first(part[g], asmall, bbig[g]);
#pragma unroll
        for (int g = 0; g < 4; ++g) mma_tf32(part[g], abig, bsmall[g]);
#pragma unroll
        for (int g = 0; g < 4; ++g) mma_tf32(part[g], abig, bbig[g]);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[g][q] += part[g][q];
      }
    }
    cp_async_wait_all();  // this step's P landed in the staging slots

    // the cell update: fragment g holds rows lg (q = 0, 1) and lg + 8 (q = 2,
    // 3), units 2 lt + (q & 1); the new h half goes to both CTAs' next buffer
    // (fp32 split into its TF32 parts)
    S* nb = hs + ((s + 1) & 1) * kP * RT * hpitch;
    const unsigned remote = map_rank(nb, c ^ 1u);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * mt + lg + 8 * hh;
      const int gr = row0 + row;
      // the reversed direction holds its zero state until t drops below the
      // row's length
      const bool update = !rev || t < rlen[hh];
      float hv[2], pv[4][2], tcv[2], cb[2];
#pragma unroll
      for (int g = 0; g < 4; ++g) ld2(slot(hh, g), pv[g]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (kV2) {
          const float ig = sigmoid_rounded<S>(round_to<S>(pv[0][j] + acc[0][2 * hh + j]));
          const float fg = sigmoid_rounded<S>(round_to<S>(pv[1][j] + acc[1][2 * hh + j]));
          const float gg = round_to<S>(tanhf(round_to<S>(pv[2][j] + acc[2][2 * hh + j])));
          const float og = sigmoid_rounded<S>(round_to<S>(pv[3][j] + acc[3][2 * hh + j]));
          const float cn = fg * cst[hh][j] + round_to<S>(ig * gg);
          if (update) cst[hh][j] = cn;
          hv[j] = update ? round_to<S>(og * round_to<S>(tanhf(cn))) : 0.f;
        } else {
          // the gate pre-activations (mode 3 stores them in place of P)
#pragma unroll
          for (int g = 0; g < 4; ++g) pv[g][j] += acc[g][2 * hh + j];
          const float ig = sigmoid_f(pv[0][j]);
          const float fg = sigmoid_f(pv[1][j]);
          const float gg = tanhf(pv[2][j]);
          const float og = sigmoid_f(pv[3][j]);
          const float cn = fg * cst[hh][j] + ig * gg;
          tcv[j] = tanhf(cn);
          cb[j] = cst[hh][j];
          if (update) cst[hh][j] = cn;
          // a held row is still at its zero state; h is fed back rounded
          hv[j] = update ? round_to<S>(og * tcv[j]) : 0.f;
        }
      }
      if constexpr (kLow) {
        st2(nb + row * hpitch + gu, hv);
        st2_cluster_bf16(remote + 2 * (row * hpitch + gu), hv);
      } else {
        float hbig[2], hsmall[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t big, small;
          split_tf32(hv[j], big, small);
          hbig[j] = __uint_as_float(big);
          hsmall[j] = __uint_as_float(small);
        }
        st2(nb + row * hpitch + gu, hbig);
        st2(nb + (RT + row) * hpitch + gu, hsmall);
        st2_cluster(remote + 4 * (row * hpitch + gu), hbig);
        st2_cluster(remote + 4 * ((RT + row) * hpitch + gu), hsmall);
      }
      if (gr < R) st2(out_at(out, gr, t), hv);
      if constexpr (kCs) {  // c after this step's update, at the output's offset
        if (gr < R) st2(csd + static_cast<long long>(gr) * (Tn * H) + t * H + gu, cst[hh]);
      }
      if constexpr (kResid) {
        if (gr < R) {
          float hold[2];  // the h this step read, bf16 already
          ld2(hb + row * hpitch + gu, hold);
          float* pp = pre_at(gr, t);
#pragma unroll
          for (int g = 0; g < 4; ++g) st2(pp + g * H, pv[g]);
          st2(out_at(hpd, gr, t), hold);
          st2(out_at(cpd, gr, t), cb);
          st2(out_at(tcd, gr, t), tcv);
        }
      }
    }
    if (s + 1 < t_end) stage(rev ? t - 1 : t + 1);  // after this thread's reads of its slots
    cluster_sync();  // the next h is complete in both CTAs; this step's reads are done
  }
  cp_async_wait_all();
}

template <typename S, int MT, int kMode, bool kTM>
int launch(const ScanArgs<S>& a, int dirs, cudaStream_t s) {
  const int tiles = (a.R + 16 * MT - 1) / (16 * MT);
  return launch_cluster(serve_scan_kernel<S, MT, kMode, kTM>, tiles, dirs, 2 * a.H * MT,
                        smem_bytes<S>(MT, a.H), s, a);
}

template <typename S>
ScanArgs<S> make_args(const void* pre, const void* wfrag, const void* lens, void* out0,
                      void* out1, long long pre_dir, int pre_step, int out_step, int reverse1,
                      int R, int Tn, int H) {
  ScanArgs<S> a = {};
  a.pre = static_cast<float*>(const_cast<void*>(pre));
  a.wfrag = static_cast<const S*>(wfrag);
  a.lens = static_cast<const int*>(lens);
  a.out[0] = static_cast<S*>(out0);
  a.out[1] = static_cast<S*>(out1);
  a.pre_dir = pre_dir;
  a.pre_step = pre_step;
  a.out_step = out_step;
  a.reverse1 = reverse1;
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  return a;
}

template <typename S, int kMode, bool kTM = false>
int scan(int height, const ScanArgs<S>& a, int dirs, cudaStream_t s) {
  switch (height) {
    case 16: return launch<S, 1, kMode, kTM>(a, dirs, s);
    case 32: return launch<S, 2, kMode, kTM>(a, dirs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// modes 0 and 3 in either layout (time_major: 0 batch-major, 1 time-major)
template <typename S, int kMode>
int scan_in(int time_major, int height, const ScanArgs<S>& a, int dirs, cudaStream_t s) {
  return time_major ? scan<S, kMode, true>(height, a, dirs, s)
                    : scan<S, kMode, false>(height, a, dirs, s);
}

// mode 4 in the stream type S: the outputs H apart, no lengths, no reversed
// direction, and the cell states
template <typename S>
int cs_scan(int height, const void* pre, const void* wfrag, void* out0, void* out1, void* cs0,
            void* cs1, long long pre_dir, int pre_step, int dirs, int R, int Tn, int H,
            cudaStream_t s) {
  auto a = make_args<S>(pre, wfrag, nullptr, out0, out1, pre_dir, pre_step, H, 0, R, Tn, H);
  a.cs[0] = static_cast<float*>(cs0);
  a.cs[1] = static_cast<float*>(cs1);
  return scan<S, 4>(height, a, dirs, s);
}

template <typename S, int kMode>
int clusters(int height, int H, int* n) {
  switch (height) {
    case 16:
      return max_clusters(serve_scan_kernel<S, 1, kMode, false>, 2 * H, smem_bytes<S>(1, H), n);
    case 32:
      return max_clusters(serve_scan_kernel<S, 2, kMode, false>, 4 * H, smem_bytes<S>(2, H), n);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The serving scan over `dirs` (1 or 2) directions. height: rows per tile, 16
// or 32. dtype: the stream type of wfrag and the outputs, 0 = float32, 1 =
// bfloat16, 2 = bfloat16 with the cell update rounded as the manual-DMA TPU
// kernel rounds (the gates, each operation of the activations, i * g, tanh(c)
// and h). pre: P (the input product with the bias, fp32), read only;
// direction d's gate column j at row-step (r, t) is pre[d * pre_dir + (r * T
// + t) * pre_step + j]: (4H, 8H) for the pair's [R, T, 2, 4H], (R T 4H, 4H)
// for the stack's [D, R, T, 4H]. wfrag: W_hh in fragment order, float32
// [dirs d, 2 c, H / 8 ks, H / 16 w, 8 lg, 4 lt, 4 gate, 2 j], element
// W_hh[d][8 ks + lt + 4 j][gate * H + c H / 2 + 8 w + lg] (unit group w, lane
// 4 lg + lt); bfloat16 [dirs d, 2 c, H / 16 ks, H / 16 w, 2 j, 8 lg, 4 lt,
// 4 gate, 2 e], element W_hh[d][16 ks + 8 j + 2 lt + e][gate * H + c H / 2 +
// 8 w + lg]. out0, out1: direction 0's and 1's outputs, unit u of row-step (r,
// t) at (r * T + t) * out_step + u: out_step = H for [R, T, H] each, 2H for
// the two side by side in one [R, T, 2H] (out1 = out0 + H; any dtype);
// out1 unused with one direction. reverse1: direction 1 scans t = T-1..0.
// lens: [R] int32 or null (only with reverse1). time_major: 1 for the
// time-major layout (row-step (r, t) at (t * R + r) in P and the outputs;
// dtype 0 or 1 with out_step H only), 0 for the batch-major one. Every
// pointer 16-byte aligned, out_step and H multiples of 16, H at most 128.
// Returns a cudaError_t code (0 = launched).
int bilstm2_serve_scan(int height, int dtype, const void* pre, const void* wfrag,
                       const void* lens, void* out0, void* out1, long long pre_dir, int pre_step,
                       int out_step, int reverse1, int dirs, int R, int Tn, int H, int time_major,
                       void* stream) {
  if (H % 16 || H > 128 || H <= 0 || out_step % 16 || out_step < H || dirs < 1 || dirs > 2 ||
      (lens != nullptr && !reverse1) || (time_major && (out_step != H || dtype > 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto fp = make_args<float>(pre, wfrag, lens, out0, out1, pre_dir, pre_step, out_step,
                                   reverse1, R, Tn, H);
  const auto bf = make_args<__nv_bfloat16>(pre, wfrag, lens, out0, out1, pre_dir, pre_step,
                                           out_step, reverse1, R, Tn, H);
  switch (dtype) {
    case 0: return out_step == H ? scan_in<float, 0>(time_major, height, fp, dirs, s)
                                 : scan<float, 1>(height, fp, dirs, s);
    case 1: return out_step == H ? scan_in<__nv_bfloat16, 0>(time_major, height, bf, dirs, s)
                                 : scan<__nv_bfloat16, 1>(height, bf, dirs, s);
    case 2: return scan<__nv_bfloat16, 2>(height, bf, dirs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 training forward (mode 3, see the header) over `dirs` (1 or 2)
// directions: bilstm2_serve_scan's arguments at dtype 1 with the outputs H
// apart, and the residual streams. pre: P in, overwritten with the gate
// pre-activations (fp32, the same layout). hp_d, cp_d, tc_d: direction d's h
// and c before each step and tanh(c) after it, [R, T, H] bf16 (direction 1's
// unused with one direction). wfrag: bilstm2_serve_scan's bf16 fragment
// order. time_major: the layout, as bilstm2_serve_scan's (the streams lie as
// the outputs). Returns a cudaError_t code (0 = launched).
int bilstm2_serve_resid_scan(int height, void* pre, const void* wfrag, const void* lens,
                             void* out0, void* out1, void* hp0, void* cp0, void* tc0, void* hp1,
                             void* cp1, void* tc1, long long pre_dir, int pre_step, int reverse1,
                             int dirs, int R, int Tn, int H, int time_major, void* stream) {
  if (H % 16 || H > 128 || H <= 0 || dirs < 1 || dirs > 2 || (lens != nullptr && !reverse1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto a = make_args<__nv_bfloat16>(pre, wfrag, lens, out0, out1, pre_dir, pre_step, H, reverse1,
                                    R, Tn, H);
  void* streams[3][2] = {{hp0, hp1}, {cp0, cp1}, {tc0, tc1}};
  for (int d = 0; d < 2; ++d) {
    a.hp[d] = static_cast<__nv_bfloat16*>(streams[0][d]);
    a.cp[d] = static_cast<__nv_bfloat16*>(streams[1][d]);
    a.tc[d] = static_cast<__nv_bfloat16*>(streams[2][d]);
  }
  return scan_in<__nv_bfloat16, 3>(time_major, height, a, dirs, static_cast<cudaStream_t>(stream));
}

// The cell-state forward (mode 4, see the header) over `dirs` (1 or 2)
// directions, each in forward time: bilstm2_serve_scan's arguments at dtype 0
// (fp32) or 1 (bf16) with the outputs H apart, no lengths and no reversed
// direction, and cs_d: direction d's fp32 cell state after each step, [R, T,
// H] (direction 1's unused with one direction). Returns a cudaError_t code
// (0 = launched).
int bilstm2_serve_cs_scan(int height, int dtype, const void* pre, const void* wfrag, void* out0,
                          void* out1, void* cs0, void* cs1, long long pre_dir, int pre_step,
                          int dirs, int R, int Tn, int H, void* stream) {
  if (H % 16 || H > 128 || H <= 0 || dirs < 1 || dirs > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return cs_scan<float>(height, pre, wfrag, out0, out1, cs0, cs1, pre_dir, pre_step, dirs, R,
                            Tn, H, s);
    case 1:
      return cs_scan<__nv_bfloat16>(height, pre, wfrag, out0, out1, cs0, cs1, pre_dir, pre_step,
                                    dirs, R, Tn, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of the scan at this tile height and dtype (as above; 3:
// the bf16 training forward) the card runs at once. dtype 0 answers the
// smaller count of its outputs-only and cell-state instantiations (modes 0
// and 4), dtype 1 of those and the outputs side by side (mode 1): they take
// the same threads and shared memory, so one tile plan serves them all (and
// the time-major instantiations, which the same shared memory and threads and
// the 128-register cap of the launch bounds hold to the same occupancy).
int bilstm2_serve_max_clusters(int height, int dtype, int H, int* n) {
  switch (dtype) {
    case 0: {
      int apart = 0, cs = 0;
      int rc = clusters<float, 0>(height, H, &apart);
      if (rc == 0) rc = clusters<float, 4>(height, H, &cs);
      *n = apart < cs ? apart : cs;
      return rc;
    }
    case 1: {
      int apart = 0, side = 0, cs = 0;
      int rc = clusters<__nv_bfloat16, 0>(height, H, &apart);
      if (rc == 0) rc = clusters<__nv_bfloat16, 1>(height, H, &side);
      if (rc == 0) rc = clusters<__nv_bfloat16, 4>(height, H, &cs);
      *n = apart < side ? apart : side;
      *n = *n < cs ? *n : cs;
      return rc;
    }
    case 2: return clusters<__nv_bfloat16, 2>(height, H, n);
    case 3: return clusters<__nv_bfloat16, 3>(height, H, n);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bilstm2_serve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
