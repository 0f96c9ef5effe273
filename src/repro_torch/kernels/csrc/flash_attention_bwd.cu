// Backward of causal / sliding-window flash attention, float32, GQA by head
// index: dq, dk and dv from q, k, v, the forward's output o and its
// per-row log-sum-exp lse, and the output gradient do.
//
// The TPU package has no backward kernel: its LM calls plain jnp attention
// and XLA differentiates it. This is the same gradient taken by the flash
// route (the gradient of repro/kernels/flash_attention.py::
// flash_attention_pallas's function, which this file's forward twin,
// flash_attention.cu, replaces), so the (B, H, T, T) scores never reach
// device memory:
//   delta_i = sum_d do_i * o_i                      (flash_bwd_delta)
//   P = exp(S * scale - lse),  S = q k^T            (recomputed per tile)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) elementwise
//   dK = dS^T Q * scale,  dQ = dS K * scale.
// Masking is the forward's at any Tq queries over Tk keys (flash_attention.
// cu): a key is seen where kpos < Tk, kpos <= qpos (causal) and kpos > qpos
// - window (window > 0), positions counted from 0 on both sides. A masked
// entry's P is exactly 0, as the forward's exp(-1e30 - m) is. A row that
// sees no key at all (a window past the last key; its lse is +inf) is the
// mean of v in the plain function: its dO / Tk goes to every key's dV
// (flash_bwd_blind), its dQ is 0 and it adds nothing to dK. Keys that no
// query sees (causal, Tk > Tq) get dk = dv = 0 but for that term.
//
// Bound on the H100: tensor operations. At qwen3's training shape (8 x
// 1,024 tokens, 16 query heads and 8 KV heads of 128, causal) the five
// products are 5 * 2 * D FLOP a visible (query, key) pair, 86 GFLOP: 0.521
// ms as three TF32 passes at 495 TFLOP/s (1.283 ms on the FP32 pipes at 67
// TFLOP/s). The inputs and gradients are 403 MB (0.120 ms). mma.sync, the
// instruction used here, peaks near two thirds of the 495 (wgmma's rate;
// tools/mma_tf32_probe.py measures it).
//
// Design: every product on TF32 tensor cores (mma.sync m16n8k8, FP32
// accumulation) in three passes, a * b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// (tf32x3.cuh), which keeps FP32 accuracy; one pass misses the port's
// 1e-5 * (1 + m) rule at the training shape. The five products and no
// more: dS goes from the dK/dV kernel to the dQ kernel through a device
// scratch (272.6 MB at the training shape, ds_rows). It grows as B Hq Tq Tk,
// so past a budget the caller launches the kernels on slices of the batch,
// or over ranges of query rows, whose dK and dV each add to the last
// range's (kernels/flash_attention.py::bwd_plan). Three launches:
//  * flash_bwd_delta: one warp a (b, t, h) query row, delta into (B, Hq,
//    Tq).
//  * flash_bwd_dkdv: one block a (b, KV head, 64-key tile), two groups of
//    4 warps; warp w of a group owns keys 16w to 16w + 15. The groups take
//    turns over the (query head of the KV head's group, 16-row query tile)
//    pairs that see the block's keys, in head-major order. Each warp
//    computes S^T = K Q^T and dP^T = V dO^T side by side in key-row layout,
//    so its P^T and dS^T accumulators are already the A fragments of
//    dV += P^T dO and dK += dS^T Q: no score tile goes through shared
//    memory. dS^T also goes to the scratch, one 16-byte store a lane in the
//    order the dQ kernel's lanes take it. dK and dV (16 x D each) stay in
//    registers in the mma C layout; at the end group 1's are added to group
//    0's through shared memory. A fixed order and no atomics: two calls
//    give the same bits.
//  * flash_bwd_dq: dQ = dS K, one product: one block of 8 warps a (b, query
//    head, 128-row tile), a warp 16 rows, walking the 32-key tiles its rows
//    see; its dS fragments come from the scratch one tile ahead, by 16-byte
//    loads.
//  * Split once. The resident K and V of dkdv are staged raw, then split
//    into hi and lo planes in shared memory in the order a lane reads its A
//    fragments (one 16-byte load a plane a fragment). The streamed tiles
//    (Q and dO in dkdv, K in dq) land raw by 16-byte cp.async, are split
//    once into hi/lo planes, and the next tile's copy runs under this
//    tile's products (the raw buffer and the planes are its two stages).
//    A streamed tile is read two ways: as B of the products over D (rows
//    by lanes' groups, an 8-byte load a plane), and as B of the products
//    over its rows (dV, dK, dQ: the same d for two rows, a 16-byte load
//    giving four n-tiles' values, whose columns are d = 32c + 4n + i for
//    n-tile 4c + i, so that a lane ends with 8 consecutive d a row). Its
//    rows' 16-byte chunks are permuted by chunk ^ swz(row) so that both
//    reads fall in distinct banks. The query column n of S^T's n-tile j is
//    stream row 8j + n/2 + 4 (n % 2), so that the accumulator's lane
//    columns 2t and 2t + 1 are rows t and t + 4.
//  * dK, dV and dQ sum thousands of rows. The mma's own accumulation
//    truncates, a bias that grows with every addition, so a tile's passes
//    sum in a fresh accumulator that is then added to the running one on
//    the FP32 pipes (frags_by_dims).
//  * Tile skipping as the forward: a block starts at its diagonal (or its
//    window) and a warp skips a tile masked for all 16 of its rows; the
//    blocks that see the most tiles are numbered first. A dkdv tile that no
//    mask touches skips the mask arithmetic.
//  * dkdv: one block (8 warps) an SM at either D: 224 KB of shared memory
//    and 255 registers a thread at D = 128; 112.5 KB and 197 registers at
//    D = 64, where two blocks would fit the shared memory but need 100k of
//    the SM's 64k registers. dq: 48 KB, one block (8 warps) an SM by
//    registers. Both are bound by shared-memory bytes a product reads as
//    much as by the tensor pipe: a 16-row warp tile reads ~300 B of planes
//    an mma, and the 227 KB budget leaves no room for wider.
// Left: wgmma fed by TMA for all of it (ROADMAP Queue 2), and a warp tile
// wider than 16 rows to cut the shared-memory bytes a product reads.
#include <cuda_runtime.h>

#include "launch.cuh"
#include "tf32x3.cuh"

#include <cstdint>
#include <initializer_list>
#include <utility>

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::mma;
using tf32x3::split;

constexpr int kRes = 64;                 // dkdv's keys a block, 16 a warp
constexpr int kGroups = 2;               // dkdv's warp groups, taking turns
constexpr int kRows = 16;                // dkdv's query rows a streamed tile
constexpr int kDqKeys = 32;              // dq's keys a streamed tile
constexpr int kDqWarps = 8;              // dq's warps a block, 16 rows each

// dkdv's shared memory: four resident (64, D) planes in A-fragment order
// (hi and lo of K and V), then for each warp group its stream buffers: two
// raw (kRows, D) tiles, raw and staged (lse, delta) of kRows rows, and the
// four hi/lo (kRows, D) planes.
template <int D>
struct Dkdv {
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kPlane = kRes * D;
  static constexpr int kTile = kRows * D;
  static constexpr int kGroup = 6 * kTile + 4 * kRows;
  static constexpr int kStage = kRes * (D + 4);  // a staged resident tile
  static constexpr size_t bytes =
      sizeof(float) * (4 * kPlane + kGroups * kGroup);
  static_assert(2 * kStage <= kGroups * kGroup, "the staging fits");
  static_assert(128 * D <= kGroups * kGroup, "group 1's dK and dV fit");
};

// dq's shared memory: a raw (kDqKeys, D) K tile and its hi and lo planes
template <int D>
constexpr size_t kDqBytes = sizeof(float) * 3 * kDqKeys * D;

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// P = exp(s scale - lse) as 2^(s scale log2(e) - lse2), lse2 = lse log2(e)
__device__ __forceinline__ float prob(float s, float scale, float lse2) {
  return exp2f(fmaf(s, scale * kLog2e, -lse2));
}

// the chunk permutation of stream row r (even, below 8)
__device__ __forceinline__ int swz(int r) {
  return 2 * ((r & 3) ^ ((r >> 1) & 2));
}

// a barrier of one warp group's 128 threads
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;" ::"r"(group + 1) : "memory");
}

// start copying rows [row0, row0 + 64) of a (B, T, H, D) tensor at head h
// into a (64, D + 4) staging tile; rows past T (the tensor's own length) as
// zeros
template <int D, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int b, int row0, int T, int H,
                                           int h) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < kRes * C; i += NT) {
    const int r = i / C, c = i - r * C, row = row0 + r;
    const bool ok = row < T;
    const long long off =
        ok ? ((static_cast<long long>(b) * T + row) * H + h) * D + 4 * c : 0;
    cp_async16(dst + r * (D + 4) + 4 * c, src + off, ok);
  }
}

// a staged (64, D + 4) tile -> hi and lo planes in A-fragment order: warp
// w's fragment of 8-column step kk is one float4 a lane at
// ((w * D / 8 + kk) * 32 + lane) * 4, holding rows 16w + g and 16w + g + 8
// at columns 8kk + 2t and 8kk + 2t + 1 (lane = 4g + t): the contraction
// index t of the mma taken as column 2t, t + 4 as 2t + 1
template <int D, int NT>
__device__ __forceinline__ void to_fragments(const float* st, float* hi,
                                             float* lo) {
  constexpr int KK = D / 8;
  for (int i = threadIdx.x; i < kRes * D / 4; i += NT) {
    const int w = i / (KK * 32), kk = (i / 32) % KK, ln = i % 32;
    const int r = 16 * w + (ln >> 2), c = 8 * kk + 2 * (ln & 3);
    const float x[4] = {st[r * (D + 4) + c], st[(r + 8) * (D + 4) + c],
                        st[r * (D + 4) + c + 1],
                        st[(r + 8) * (D + 4) + c + 1]};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], h[e], l[e]);
    reinterpret_cast<uint4*>(hi)[i] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// start copying rows [row0, row0 + SR) of a (B, T, H, D) tensor at head h
// into a stream tile (chunks permuted); rows past T as zeros
template <int D, int SR, int NT = 128>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b, int row0, int T, int H,
                                          int h, int gtid) {
  constexpr int C = D / 4;
#pragma unroll
  for (int n = 0; n < SR * C / NT; ++n) {
    const int i = gtid + NT * n;
    const int r = i / C, c = i - r * C, row = row0 + r;
    const bool ok = row < T;
    const long long off =
        ok ? ((static_cast<long long>(b) * T + row) * H + h) * D + 4 * c : 0;
    cp_async16(dst + r * D + ((c ^ swz(r & 7)) << 2), src + off, ok);
  }
}

// a raw stream tile -> its hi and lo planes, chunk by chunk in place
template <int D, int SR, int NT = 128>
__device__ __forceinline__ void split_tile(const float* raw, float* hi,
                                           float* lo, int gtid) {
#pragma unroll
  for (int n = 0; n < SR * D / 4 / NT; ++n) {
    const int i = gtid + NT * n;
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    reinterpret_cast<uint4*>(hi)[i] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// acc = A B^T and bcc = C E^T over D, three passes each, side by side (so
// the tensor pipe has four accumulator chains an n-tile): A and C this
// warp's 16 resident rows (fragment planes), B and E the SR stream rows
// (planes). Column n of n-tile j is stream row 8j + n/2 + 4 (n % 2). The
// two small passes sum apart and are added after the loop, as in the
// forward.
template <int D, int NJ>
__device__ __forceinline__ void rows_by_stream(
    const float* Ah, const float* Al, const float* Bh, const float* Bl,
    const float* Ch, const float* Cl, const float* Eh, const float* El,
    int wq, float (&acc)[NJ][4], float (&bcc)[NJ][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rr = (g >> 1) + 4 * (g & 1);       // this lane's B row, mod 8
  const int sw = swz(rr) << 2;
  const int fo = wq * (D / 8) * 32 + lane;
  const uint4* ah = reinterpret_cast<const uint4*>(Ah) + fo;
  const uint4* al = reinterpret_cast<const uint4*>(Al) + fo;
  const uint4* ch = reinterpret_cast<const uint4*>(Ch) + fo;
  const uint4* cl = reinterpret_cast<const uint4*>(Cl) + fo;
  const int bo = rr * D + 2 * t;
  float acc2[NJ][4], bcc2[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = acc2[j][e] = bcc[j][e] = bcc2[j][e] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint4 h4 = ah[kk * 32], l4 = al[kk * 32];
    const uint4 h5 = ch[kk * 32], l5 = cl[kk * 32];
    const uint32_t a_h[4] = {h4.x, h4.y, h4.z, h4.w};
    const uint32_t a_l[4] = {l4.x, l4.y, l4.z, l4.w};
    const uint32_t c_h[4] = {h5.x, h5.y, h5.z, h5.w};
    const uint32_t c_l[4] = {l5.x, l5.y, l5.z, l5.w};
    const int o = bo + ((8 * kk) ^ sw);      // chunk 2kk + t/2, permuted
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 yh = *reinterpret_cast<const float2*>(Bh + 8 * j * D + o);
      const float2 yl = *reinterpret_cast<const float2*>(Bl + 8 * j * D + o);
      const float2 zh = *reinterpret_cast<const float2*>(Eh + 8 * j * D + o);
      const float2 zl = *reinterpret_cast<const float2*>(El + 8 * j * D + o);
      mma(acc2[j], a_l, bits(yh.x), bits(yh.y));
      mma(bcc2[j], c_l, bits(zh.x), bits(zh.y));
      mma(acc2[j], a_h, bits(yl.x), bits(yl.y));
      mma(bcc2[j], c_h, bits(zl.x), bits(zl.y));
      mma(acc[j], a_h, bits(yh.x), bits(yh.y));
      mma(bcc[j], c_h, bits(zh.x), bits(zh.y));
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += acc2[j][e];
      bcc[j][e] += bcc2[j][e];
    }
}

// acc += A B over NK 8-row steps of a stream tile, three passes: A's hi
// and lo fragments of step s as the mma takes them, whose k index t reads
// the stream row at float offset off0[s] and t + 4 the one at off1[s] (the
// offsets include this lane's 16-byte chunk g, permuted); B the planes.
// Column n of output n-tile 4c + i is d = 32c + 4n + i, so one 16-byte load
// gives four n-tiles' values. A tile's passes sum in a fresh accumulator,
// which is then added to acc on the FP32 pipes: the mma's own additions
// truncate, and over the thousands of rows that dK, dV and dQ sum, that
// bias alone would take dV past the port's tolerance at the training
// shape.
template <int D, int NK>
__device__ __forceinline__ void frags_by_dims(const uint32_t (&xh)[NK][4],
                                              const uint32_t (&xl)[NK][4],
                                              const float* Bh,
                                              const float* Bl,
                                              const int (&off0)[NK],
                                              const int (&off1)[NK],
                                              float (&acc)[D / 8][4]) {
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      const float4 h0 = *reinterpret_cast<const float4*>(Bh + off0[s] + 32 * c);
      const float4 h1 = *reinterpret_cast<const float4*>(Bh + off1[s] + 32 * c);
      const float4 l0 = *reinterpret_cast<const float4*>(Bl + off0[s] + 32 * c);
      const float4 l1 = *reinterpret_cast<const float4*>(Bl + off1[s] + 32 * c);
      const float bh0[4] = {h0.x, h0.y, h0.z, h0.w};
      const float bh1[4] = {h1.x, h1.y, h1.z, h1.w};
      const float bl0[4] = {l0.x, l0.y, l0.z, l0.w};
      const float bl1[4] = {l1.x, l1.y, l1.z, l1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma(part[i], xl[s], bits(bh0[i]), bits(bh1[i]));
        mma(part[i], xh[s], bits(bl0[i]), bits(bl1[i]));
        mma(part[i], xh[s], bits(bh0[i]), bits(bh1[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * c + i][e] += part[i][e];
  }
}

// acc += X B over the SR stream rows: X (16 x SR) in the C layout
// rows_by_stream leaves (lane columns 2t and 2t + 1 of n-tile j are stream
// rows 8j + t and 8j + t + 4), split here into A fragments
template <int D, int NJ>
__device__ __forceinline__ void rows_by_dims(const float (&x)[NJ][4],
                                             const float* Bh,
                                             const float* Bl,
                                             float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t xh[NJ][4], xl[NJ][4];
  int off0[NJ], off1[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split(x[j][0], xh[j][0], xl[j][0]);
    split(x[j][2], xh[j][1], xl[j][1]);
    split(x[j][1], xh[j][2], xl[j][2]);
    split(x[j][3], xh[j][3], xl[j][3]);
    off0[j] = (8 * j + t) * D + ((g ^ swz(t)) << 2);
    off1[j] = (8 * j + t + 4) * D + ((g ^ swz(t + 4)) << 2);
  }
  frags_by_dims<D, NJ>(xh, xl, Bh, Bl, off0, off1, acc);
}

// The dS scratch: 16 x 16 blocks (query block qb, key block kb) of each
// (b, query head), those a query can see, rows in order, nbk key blocks a
// side: when causal the lower triangle, query block qb holding min(qb + 1,
// nbk) of them (all nbk past the last key block, where Tq > Tk), all nbk
// otherwise. A launch over the query rows [qbegin,
// qend) holds only their blocks (ds_rows of them a (b, query head)). A block
// holds the A fragments of dQ += dS K for its 16 rows and two 8-key steps as
// the dq kernel's lanes take them: step ks, lane (g, t) at float4
// ks * 32 + 4g + t holds rows qrow(g) and qrow(g) + 4 at key 4ks + t, then
// the same rows at key 4ks + t + 8, with qrow(g) = 8 (g / 4) + g % 4: one
// 16-byte store a lane in dkdv, one 16-byte load in dq.
__host__ __device__ inline long long ds_block(int qb, int kb, int nb,
                                              int causal) {
  const long long q = qb;
  if (!causal) return q * nb + kb;
  return (qb <= nb ? q * (q + 1) / 2
                   : static_cast<long long>(nb) * (nb + 1) / 2 +
                         (q - nb) * nb) + kb;
}

// the blocks of query blocks [qb0, qb1) of one (b, query head)
__host__ __device__ inline long long ds_rows(int qb0, int qb1, int nb,
                                             int causal) {
  return ds_block(qb1, 0, nb, causal) - ds_block(qb0, 0, nb, causal);
}

// some query of block qb sees some key of block kb (inside Tq and Tk)
__device__ __forceinline__ bool block_seen(int qb, int kb, int causal,
                                           int window) {
  return !(causal && kb > qb) &&
         !(window > 0 && 16 * kb + 15 <= 16 * qb - window);
}

// row half hr (rows g, g + 8) of a (16, D) accumulator, times `mul`, into
// a global row: a lane's 8 consecutive d at 32c + 8t
template <int D>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&acc)[D / 8][4],
                                          int hr, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    float4* p = reinterpret_cast<float4*>(dst + 32 * c + 8 * t);
    const int e = 2 * hr;
    p[0] = make_float4(acc[4 * c][e] * mul, acc[4 * c + 1][e] * mul,
                       acc[4 * c + 2][e] * mul, acc[4 * c + 3][e] * mul);
    p[1] = make_float4(acc[4 * c][e + 1] * mul, acc[4 * c + 1][e + 1] * mul,
                       acc[4 * c + 2][e + 1] * mul,
                       acc[4 * c + 3][e + 1] * mul);
  }
}

// the inverse of store_row at mul 1: acc's row half hr += a global row
template <int D>
__device__ __forceinline__ void add_row(const float* src,
                                        float (&acc)[D / 8][4], int hr) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    const float4* p = reinterpret_cast<const float4*>(src + 32 * c + 8 * t);
    const float4 x = p[0], y = p[1];
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
    const int e = 2 * hr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[4 * c + i][e] += xs[i];
      acc[4 * c + i][e + 1] += ys[i];
    }
  }
}

// with two warp groups, group 1 hands each accumulator to group 0 through
// shared memory (put_acc), and group 0 adds it to its own (add_acc): group
// 0 + group 1, a fixed order
template <int D>
__device__ __forceinline__ void put_acc(float* buf,
                                        const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      buf[(n * 4 + e) * 128 + (threadIdx.x & 127)] = acc[n][e];
}

template <int D>
__device__ __forceinline__ void add_acc(const float* buf,
                                        float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] += buf[(n * 4 + e) * 128 + (threadIdx.x & 127)];
}

// delta[(b, h, t)] = <do, o> of the (b, t, h) row: one warp a row, T the
// query length
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dO,
                    float* __restrict__ delta, long long rows, int T,
                    int Hq) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  if (lane < D / 4) {
    const float4 a = *reinterpret_cast<const float4*>(o + row * D + 4 * lane);
    const float4 g =
        *reinterpret_cast<const float4*>(dO + row * D + 4 * lane);
    acc = fmaf(a.w, g.w, fmaf(a.z, g.z, fmaf(a.y, g.y, a.x * g.x)));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const long long bt = row / Hq;
    const long long b = bt / T, t = bt - b * T;
    delta[(b * Hq + h) * T + t] = acc;
  }
}

// dV of the rows from `blind` on, which see no key (a window past the last
// key): the plain function's softmax gives such a row p = 1 / Tk on every
// key, so each key's dV gains (1 / Tk) times the sum of those rows' dO over
// the KV head's query heads; their dQ is 0 and they add nothing to dK (the
// mask cuts the scores' gradient). One block a (b, KV head), a thread a
// column; it runs after the last range's dkdv, on its dV.
template <int D>
__global__ void __launch_bounds__(D)
    flash_bwd_blind(const float* __restrict__ dO, float* __restrict__ dv,
                    int Tq, int Tk, int Hq, int Hkv, int blind) {
  const int b = blockIdx.x / Hkv, hk = blockIdx.x - b * Hkv;
  const int q_per_kv = Hq / Hkv, c = threadIdx.x;
  float u = 0.f;
  for (int r = blind; r < Tq; ++r)
    for (int i = 0; i < q_per_kv; ++i)
      u += dO[((static_cast<long long>(b) * Tq + r) * Hq + hk * q_per_kv +
               i) * D + c];
  u /= static_cast<float>(Tk);
  for (int key = 0; key < Tk; ++key)
    dv[((static_cast<long long>(b) * Tk + key) * Hkv + hk) * D + c] += u;
}

// the 64-key tiles a dkdv launch over the query rows [qbegin, qend) takes:
// when causal, those a row of the range can see, and every tile of Tk in
// the launch that ends at Tq, so that keys no query sees get their zeros
__host__ __device__ inline int dkdv_tiles(int Tq, int Tk, int causal,
                                          int qend) {
  const int keys = causal && qend < Tq ? (qend < Tk ? qend : Tk) : Tk;
  return (keys + kRes - 1) / kRes;
}

// R: the launch is one of several over ranges of query rows; without it
// the range is all Tq and the range arithmetic folds away
template <int D, bool R>
__global__ void __launch_bounds__(128 * kGroups, 1)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ dsb, int Tq,
                   int Tk, int Hq, int Hkv, int causal, int window,
                   float scale, int qbegin, int qend) {
  using L = Dkdv<D>;
  constexpr int NG = kGroups, SR = kRows, NJ = SR / 8;
  extern __shared__ __align__(16) float smem[];
  float* Kh = smem;
  float* Kl = Kh + L::kPlane;
  float* Vh = Kl + L::kPlane;
  float* Vl = Vh + L::kPlane;
  float* groups = Vl + L::kPlane;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / 4, wq = warp % 4, gtid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  if (!R) qbegin = 0, qend = Tq;
  const int n_kt = dkdv_tiles(Tq, Tk, causal, qend);
  const int n_bh = gridDim.x / n_kt;
  const int kt = blockIdx.x / n_bh;      // first tiles see the most rows
  const int bh = blockIdx.x - kt * n_bh;
  const int b = bh / Hkv, hk = bh - b * Hkv, q_per_kv = Hq / Hkv;
  const int k0 = kt * kRes, kw = k0 + 16 * wq;
  const int n_qt = (Tq + SR - 1) / SR;
  // the query tiles that see these keys, then those of this launch (none
  // for keys past the last query when causal: their zeros are stored)
  const int seen_begin = causal ? k0 / SR : 0;
  int seen_end = n_qt - 1;               // inclusive
  if (window > 0) seen_end = min(seen_end, (k0 + kRes - 2 + window) / SR);
  const int c0 = qbegin / SR, c1 = (qend + SR - 1) / SR;
  const bool first = !R || seen_begin >= c0, last = !R || seen_end < c1;
  const int qt_begin = R ? max(seen_begin, c0) : seen_begin;
  const int per_head = (R ? min(seen_end, c1 - 1) : seen_end) - qt_begin + 1;
  if (R && per_head <= 0 && seen_begin <= seen_end)
    return;                              // another launch's keys
  const int n_iter = q_per_kv * max(per_head, 0);  // (head, query tile)
  const int nb = (Tk + 15) >> 4, qb0 = qbegin >> 4;
  const long long ds_base = ds_block(qb0, 0, nb, causal);

  // K and V staged raw, then split once into fragment planes
  stage_rows<D, L::kThreads>(groups, k, b, k0, Tk, Hkv, hk);
  stage_rows<D, L::kThreads>(groups + L::kStage, v, b, k0, Tk, Hkv, hk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  to_fragments<D, L::kThreads>(groups, Kh, Kl);
  to_fragments<D, L::kThreads>(groups + L::kStage, Vh, Vl);
  __syncthreads();

  float* raw = groups + group * L::kGroup;  // raw Q, then raw dO
  float* rstat = raw + 2 * L::kTile;        // raw lse, delta
  float* stat = rstat + 2 * SR;             // this tile's lse, delta
  float* Qh = stat + 2 * SR;
  float* Ql = Qh + L::kTile;
  float* Oh = Ql + L::kTile;
  float* Ol = Oh + L::kTile;

  // iteration it's Q, dO, lse and delta into the raw buffers
  auto load = [&](int it) {
    const int h = hk * q_per_kv + it / per_head;
    const int q0 = (qt_begin + it % per_head) * SR;
    load_tile<D, SR>(raw, q, b, q0, Tq, Hq, h, gtid);
    load_tile<D, SR>(raw + L::kTile, dO, b, q0, Tq, Hq, h, gtid);
    if (gtid < SR) {
      const bool ok = q0 + gtid < Tq;
      const long long i =
          ok ? (static_cast<long long>(b) * Hq + h) * Tq + q0 + gtid : 0;
      cp_async4(rstat + gtid, lse + i, ok);
      cp_async4(rstat + SR + gtid, delta + i, ok);
    }
  };

  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  if (group < n_iter) load(group);
  cp_async_commit();
  for (int it = group; it < n_iter; it += NG) {
    cp_async_wait<0>();
    group_sync(group);                   // landed; the planes are free
    split_tile<D, SR>(raw, Qh, Ql, gtid);
    split_tile<D, SR>(raw + L::kTile, Oh, Ol, gtid);
    if (gtid < 2 * SR)                   // lse as lse2 (prob)
      stat[gtid] = gtid < SR ? rstat[gtid] * kLog2e : rstat[gtid];
    group_sync(group);
    if (it + NG < n_iter) load(it + NG);  // under this tile's products
    cp_async_commit();
    const int q0 = (qt_begin + it % per_head) * SR;
    if (kw >= Tk || (causal && q0 + SR - 1 < kw) ||
        (window > 0 && kw + 15 <= q0 - window))
      continue;                          // masked for all 16 keys
    // P^T = exp(S^T scale - lse), S^T = K Q^T: rows keys, columns queries;
    // dP^T = V dO^T beside it
    float p[NJ][4], ds[NJ][4];
    rows_by_stream<D, NJ>(Kh, Kl, Qh, Ql, Vh, Vl, Oh, Ol, wq, p, ds);
    if (q0 + SR <= Tq && kw + 16 <= Tk && (!causal || kw + 15 <= q0) &&
        (window <= 0 || kw > q0 + SR - 1 - window)) {   // nothing masked
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = prob(p[j][e], scale, stat[8 * j + t + 4 * (e & 1)]);
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + g + 8 * (e >> 1);
          const int qi = 8 * j + t + 4 * (e & 1), qpos = q0 + qi;
          bool ok = qpos < Tq && key < Tk;
          if (causal) ok = ok && key <= qpos;
          if (window > 0) ok = ok && key > qpos - window;
          p[j][e] = ok ? prob(p[j][e], scale, stat[qi]) : 0.f;
        }
    }
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - stat[SR + 8 * j + t + 4 * (e & 1)]);
    // dS to the scratch: n-tile j is half of block (q0 / 16 + j / 2, kw / 16)
    {
      const int h = hk * q_per_kv + it / per_head, kb = kw >> 4;
      float* bh_ds = dsb + (static_cast<long long>(b) * Hq + h) *
                               ds_rows(qb0, (qend + 15) >> 4, nb, causal) *
                               256;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qb = (q0 >> 4) + (j >> 1);
        if (16 * qb < Tq && block_seen(qb, kb, causal, window))
          reinterpret_cast<float4*>(
              bh_ds + (ds_block(qb, kb, nb, causal) - ds_base) * 256)
              [(g >> 2) * 32 + 16 * (j & 1) + 4 * t + (g & 3)] =
              make_float4(ds[j][0], ds[j][1], ds[j][2], ds[j][3]);
      }
    }
    rows_by_dims<D, NJ>(p, Oh, Ol, av);    // dV += P^T dO
    rows_by_dims<D, NJ>(ds, Qh, Ql, ak);   // dK += dS^T Q
  }
  __syncthreads();                       // every group's last tile is read
  if (group == 1) {
    put_acc<D>(groups, ak);
    put_acc<D>(groups + 64 * D, av);
  }
  __syncthreads();
  if (group == 1) return;
  add_acc<D>(groups, ak);
  add_acc<D>(groups + 64 * D, av);
  // an earlier launch's sums (unscaled) are added; scaled by the last
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kw + g + 8 * hr;
    if (key < Tk) {
      const long long off =
          ((static_cast<long long>(b) * Tk + key) * Hkv + hk) * D;
      if (!first) {
        add_row<D>(dk + off, ak, hr);
        add_row<D>(dv + off, av, hr);
      }
      store_row<D>(dk + off, ak, hr, last ? scale : 1.f);
      store_row<D>(dv + off, av, hr, 1.f);
    }
  }
}

template <int D, bool R>
__global__ void __launch_bounds__(32 * kDqWarps, 1)
    flash_bwd_dq(const float* __restrict__ k, const float* __restrict__ dsb,
                 float* __restrict__ dq, int Tq, int Tk, int Hq, int Hkv,
                 int causal, int window, float scale, int qbegin, int qend) {
  constexpr int SR = kDqKeys, QW = kDqWarps;
  constexpr int NK = SR / 8;             // 8-key steps a tile
  constexpr int kTile = SR * D;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;
  float* Kh = raw + kTile;
  float* Kl = Kh + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kBlockRows = 16 * QW;
  if (!R) qbegin = 0, qend = Tq;
  const int n_qt = (qend - qbegin + kBlockRows - 1) / kBlockRows;
  const int n_bh = gridDim.x / n_qt;
  const int qt =
      qbegin / kBlockRows + n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = blockIdx.x % n_bh;
  const int b = bh / Hq, h = bh - b * Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kBlockRows, qw = q0 + 16 * warp, qb = qw >> 4;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / SR;
  int last_key = Tk - 1;
  if (causal) last_key = min(last_key, q0 + kBlockRows - 1);
  // no tile at all where every row's window lies past the last key
  const int n_iter = max(last_key / SR - kt_begin + 1, 0);
  const int nb = (Tk + 15) >> 4, qb0 = qbegin >> 4;
  const long long ds_base = ds_block(qb0, 0, nb, causal);
  const float* bh_ds = dsb + (static_cast<long long>(b) * Hq + h) *
                                 ds_rows(qb0, (qend + 15) >> 4, nb, causal) *
                                 256;

  // step s of a tile: key block s / 2 of it, 8-key step s % 2, whose k
  // index t is key 4 (s % 2) + t of the block and t + 4 is that + 8
  int off0[NK], off1[NK];
#pragma unroll
  for (int s = 0; s < NK; ++s) {
    const int r = 16 * (s >> 1) + 4 * (s & 1) + t;
    off0[s] = r * D + ((g ^ swz(r & 7)) << 2);
    off1[s] = off0[s] + 8 * D;
  }
  // this lane's dS fragments of tile it (zeros where its rows see none of
  // a key block, which dkdv does not write)
  auto fetch = [&](int it, float4 (&f)[NK]) {
    const int kb0 = (kt_begin + it) * SR >> 4;
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      const int kb = kb0 + (s >> 1);
      f[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qw < Tq && 16 * kb < Tk && block_seen(qb, kb, causal, window))
        f[s] = reinterpret_cast<const float4*>(
            bh_ds + (ds_block(qb, kb, nb, causal) - ds_base) * 256)
            [(s & 1) * 32 + lane];
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (n_iter > 0)
    load_tile<D, SR, 32 * QW>(raw, k, b, kt_begin * SR, Tk, Hkv, hk,
                              threadIdx.x);
  cp_async_commit();
  float4 f[NK];
  if (n_iter > 0) fetch(0, f);
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();
    __syncthreads();                     // landed; the planes are free
    split_tile<D, SR, 32 * QW>(raw, Kh, Kl, threadIdx.x);
    __syncthreads();
    if (it + 1 < n_iter)                 // under this tile's products
      load_tile<D, SR, 32 * QW>(raw, k, b, (kt_begin + it + 1) * SR, Tk,
                                Hkv, hk, threadIdx.x);
    cp_async_commit();
    uint32_t xh[NK][4], xl[NK][4];
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      split(f[s].x, xh[s][0], xl[s][0]);
      split(f[s].y, xh[s][1], xl[s][1]);
      split(f[s].z, xh[s][2], xl[s][2]);
      split(f[s].w, xh[s][3], xl[s][3]);
    }
    if (it + 1 < n_iter) fetch(it + 1, f);
    const int ks = (kt_begin + it) * SR;
    if (qw >= Tq || (causal && ks > qw + 15) ||
        (window > 0 && ks + SR - 1 <= qw - window))
      continue;                          // masked for all 16 rows
    frags_by_dims<D, NK>(xh, xl, Kh, Kl, off0, off1, acc);  // dQ += dS K
  }
  // accumulator rows g and g + 8 are queries qw + qrow(g) and that + 4
  const int row = qw + 8 * (g >> 2) + (g & 3);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    if (row + 4 * hr < Tq)
      store_row<D>(
          dq + ((static_cast<long long>(b) * Tq + row + 4 * hr) * Hq + h) * D,
          acc, hr, scale);
}

template <int D>
struct BwdAttr {};

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* lse, const float* dO,
                   float* scratch, float* dq, float* dk, float* dv, int B,
                   int Tq, int Tk, int Hq, int Hkv, int causal, int window,
                   float scale, int qbegin, int qend, int device,
                   cudaStream_t st) {
  using L = Dkdv<D>;
  // the shared-memory limits and carveout, once per device
  cudaError_t err = rt::once_per_device<BwdAttr<D>>(device, [] {
    for (auto [kernel, smem] :
         {std::pair<const void*, int>{
              reinterpret_cast<const void*>(flash_bwd_dkdv<D, false>),
              static_cast<int>(L::bytes)},
          std::pair<const void*, int>{
              reinterpret_cast<const void*>(flash_bwd_dkdv<D, true>),
              static_cast<int>(L::bytes)},
          std::pair<const void*, int>{
              reinterpret_cast<const void*>(flash_bwd_dq<D, false>),
              static_cast<int>(kDqBytes<D>)},
          std::pair<const void*, int>{
              reinterpret_cast<const void*>(flash_bwd_dq<D, true>),
              static_cast<int>(kDqBytes<D>)}}) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            static_cast<int>(cudaSharedmemCarveoutMaxShared));
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * Tq * Hq;
  const long long kv_blocks = static_cast<long long>(B) * Hkv *
                              dkdv_tiles(Tq, Tk, causal, qend);
  const long long dq_blocks =
      static_cast<long long>(B) * Hq *
      ((qend - qbegin + 16 * kDqWarps - 1) / (16 * kDqWarps));
  if ((rows + 7) / 8 > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      dq_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  float* delta = scratch;
  float* dsb = scratch + (rows + 3) / 4 * 4;
  if (qbegin == 0) {                     // the later launches reuse it
    flash_bwd_delta<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
        o, dO, delta, rows, Tq, Hq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bool ranged = qbegin > 0 || qend < Tq;
  (ranged ? flash_bwd_dkdv<D, true> : flash_bwd_dkdv<D, false>)
      <<<static_cast<unsigned>(kv_blocks), L::kThreads, L::bytes, st>>>(
          q, k, v, dO, lse, delta, dk, dv, dsb, Tq, Tk, Hq, Hkv, causal,
          window, scale, qbegin, qend);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  (ranged ? flash_bwd_dq<D, true> : flash_bwd_dq<D, false>)
      <<<static_cast<unsigned>(dq_blocks), 32 * kDqWarps, kDqBytes<D>, st>>>(
          k, dsb, dq, Tq, Tk, Hq, Hkv, causal, window, scale, qbegin,
          qend);
  if (qend == Tq && window > 0 && Tk - 1 + window < Tq) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_blind<D><<<static_cast<unsigned>(B * Hkv), D, 0, st>>>(
        dO, dv, Tq, Tk, Hq, Hkv, Tk - 1 + window);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// q, o, do, dq (B, Tq, Hq, D); k, v, dk, dv (B, Tk, Hkv, D); lse (B, Hq,
// Tq); all contiguous float32. One launch of each kernel over the query
// rows [qbegin, qend) (qbegin a multiple of 128, qend one too or Tq): the
// dK and dV of a launch after the first add to what the earlier ones wrote,
// so the launches of one call take the ranges in order, the first at qbegin
// 0, the last ending at Tq (kernels/flash_attention.py::bwd_plan). scratch,
// scratch_floats long: delta (B, Hq, Tq), rounded up to a multiple of 4
// floats, written by the qbegin-0 launch, then the range's dS blocks
// (ds_rows of them a (b, query head), 256 floats each).
extern "C" int rt_flash_attention_bwd(const float* q, const float* k,
                                      const float* v, const float* o,
                                      const float* lse, const float* dO,
                                      float* scratch,
                                      long long scratch_floats, float* dq,
                                      float* dk, float* dv, int B, int Tq,
                                      int Tk, int Hq, int Hkv, int D,
                                      int causal, int window, float scale,
                                      int qbegin, int qend, int device,
                                      void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      window < 0 || qbegin < 0 || qbegin >= qend || qend > Tq ||
      qbegin % (16 * kDqWarps) || (qend < Tq && qend % (16 * kDqWarps)))
    return cudaErrorInvalidValue;
  const int nb = (Tk + 15) / 16;
  if ((static_cast<long long>(B) * Hq * Tq + 3) / 4 * 4 +
          static_cast<long long>(B) * Hq * 256 *
              ds_rows(qbegin / 16, (qend + 15) / 16, nb, causal) >
      scratch_floats)
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dO) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv) ||
      !aligned16(scratch))
    return cudaErrorMisalignedAddress;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, dO, scratch, dq, dk, dv, B, Tq, Tk,
                      Hq, Hkv, causal, window, scale, qbegin, qend, device,
                      st);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, dO, scratch, dq, dk, dv, B, Tq, Tk,
                       Hq, Hkv, causal, window, scale, qbegin, qend, device,
                       st);
  return cudaErrorInvalidValue;
}
