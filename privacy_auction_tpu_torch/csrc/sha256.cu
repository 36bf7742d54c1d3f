// SHA-256 of a batch of byte messages, for Hopper (sm_90a): the port's
// counterpart of the JAX package's device loop (privacy_auction_tpu/ops/
// sha256.py: one hash state a lane, the blocks walked by lax.scan, the 64
// rounds by lax.fori_loop).  It replaces no Pallas kernel; it is the
// Fiat-Shamir hash of every proof (nizk.fs_challenge) and CCS22's
// commitment hash (ccs22.setup_from).
//
// Built by privacy_auction_tpu_torch/ops/cuda_ec.py beside ec_ladders.cu
// (one nvcc each, started together) and bound through ctypes: the extern
// "C" launcher takes raw device pointers and a CUDA stream, launches on that
// stream and returns cudaGetLastError().
//
// What bounds it: at the batches the paths hash (1-2,053 messages) a
// message's chain of rounds, not the card's integer rate
// (cuda_ec.SHA256_OPS_PER_BLOCK a block): 64 rounds a block, each block on
// the last, and each round's new e on the old e through Sigma1 (funnel
// shifts, one 3-input xor) and one 3-input add, 20.3 clocks on the H100
// (`pa_sha256_chain_clocks`).  Measured there (PERF.md), a round
// on one thread takes some 31-32 clocks even alone on K + W in shared
// memory: its 16 instructions issue in order from one warp, about two
// clocks each.  A thread that also expands the message schedule, loads
// the bytes and makes the padding, with that code in its loop, took 53.
//
// Design: so each block of the grid (a CTA) serves 32 messages with three
// warps, and one of them does nothing but the rounds.  Warp 0, the
// consumer, holds one message a thread and runs the 64 rounds of each
// block on its hash state, eight an iteration of a rolled loop (the
// state's rename period: 2 KB of code), reading K[t] + W[t] of the next
// eight from shared memory while it computes these; d + h + K + W is
// summed off the chain.  Warps 1 and 2, the producers, take the ring's
// fills in turn, each running ahead of the consumer: a ring of kSlots
// slots in shared memory, [slot][t][column], that a warp fills by loading
// each message block (whole big-endian words where `aligned`, bytes
// otherwise, issued together a fill ahead of their use), making the
// padding (0x80, zeros, the 64-bit bit length) in place, expanding the 48
// scheduled words and adding K.  A slot's 32 columns are (lane, block)
// pairs (`ring_pair`): with L lanes in the CTA a fill holds q consecutive
// blocks of each (q the largest power of two with q L <= 32), so with one
// long message (CCS22's evaluator) a producer's 32 threads expand 32
// blocks at once and the schedule never waits on the chain.  The
// consumer's 32 threads read 32 consecutive words of a row: no bank
// conflicts.  Named barriers pass the slots, each between the consumer
// and the slot's producer: full[s] (the producer arrives, the consumer
// waits) and empty[s] (the reverse); a waiting warp sleeps in the barrier
// and polls nothing, and nothing needs setting up.  Threads past the CTA's
// lanes keep in step through every barrier and read and write nothing;
// every branch and address depends on lengths, lane counts and block
// indices only, never on the message's bytes (ccs22.setup_from hashes
// secrets).  The digest is written as (B, 8) int64 words, the plain
// version's layout.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kProducers = 2;        // producer warps, fill f by f % kProducers
constexpr int kThreads = (1 + kProducers) * kWarp;  // the consumer warp first
constexpr int kSlots = 4;            // ring slots: 4 x 8 KiB
constexpr int kRounds = 64;
constexpr int kGroup = 8;            // rounds a consumer iteration
constexpr int kSlotWords = kRounds * kWarp;
// named barrier ids (0 is __syncthreads'): full[s], empty[s], each
// between the consumer warp and the warp that fills slot s
constexpr int kFullBar = 1;
constexpr int kEmptyBar = 1 + kSlots;
constexpr int kBarThreads = 2 * kWarp;

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__constant__ uint32_t kH0[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                                0x1F83D9ABu, 0x5BE0CD19u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int k) {
  return __funnelshift_r(x, x, k);
}

__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}

__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}

__device__ __forceinline__ uint32_t small_sigma0(uint32_t w) {
  return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3);
}

__device__ __forceinline__ uint32_t small_sigma1(uint32_t w) {
  return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10);
}

// ---- the work split: plain index arithmetic -------------------------------
// CTA `cta` serves lanes 32 * cta ... of the launch: L of them.  Fill f of
// the ring goes to slot f % kSlots and holds blocks f * q ... f * q + q - 1
// of each of its L lanes, q the largest power of two with q * L <= 32 (so
// the consumer's block loop divides by shifts); column j * L + l holds
// block f * q + j of lane l.
static_assert((kSlots & (kSlots - 1)) == 0 && kSlots % kProducers == 0,
              "kSlots: a power of two, each slot always one warp's");

__device__ __forceinline__ int cta_lanes(long long lanes, long long cta) {
  const long long left = lanes - cta * kWarp;
  return left < kWarp ? (int)left : kWarp;
}

// log2 of q: 5 - ceil(log2 L), for L in 1 ... 32
__device__ __forceinline__ int fill_shift(int L) { return __clz(L - 1) - 27; }

__device__ __forceinline__ int blocks_a_fill(int L) { return 1 << fill_shift(L); }

__device__ __forceinline__ long long ring_fills(long long blocks, int L) {
  return (blocks + blocks_a_fill(L) - 1) >> fill_shift(L);
}

__device__ __forceinline__ int ring_slot(long long fill) {
  return (int)(fill & (kSlots - 1));
}

// Producer thread p's pair in fill f: its lane in the CTA and the message
// block; false where the column is past the fill's pairs or the block past
// the message.
__device__ __forceinline__ bool ring_pair(int p, int L, long long f,
                                          long long blocks, int* lane,
                                          long long* block) {
  *lane = p % L;
  *block = (f << fill_shift(L)) + p / L;
  return p < L << fill_shift(L) && *block < blocks;
}

// The fill that holds block b of every lane, and lane l's column there.
__device__ __forceinline__ long long block_fill(long long b, int L) {
  return b >> fill_shift(L);
}

__device__ __forceinline__ int block_column(int l, int L, long long b) {
  return (int)(b & (blocks_a_fill(L) - 1)) * L + l;
}

// The passing of slots.  The consumer waits for fill_awaited(b) before it
// reads block b (its fill's first block; -1: none), and gives back the slot
// of fill_released(b) after block b (a fill's last block, when a later fill
// reuses the slot; -1: none); the producer waits for that of
// fill_reused(f) before it writes fill f.
__device__ __forceinline__ long long fill_awaited(long long b, int L) {
  return (b & (blocks_a_fill(L) - 1)) == 0 ? block_fill(b, L) : -1;
}

__device__ __forceinline__ long long fill_released(long long b, int L,
                                                   long long blocks) {
  const long long f = block_fill(b, L);
  const bool last = (~b & (blocks_a_fill(L) - 1)) == 0;
  return last && f + kSlots < ring_fills(blocks, L) ? f : -1;
}

__device__ __forceinline__ long long fill_reused(long long f) {
  return f >= kSlots ? f - kSlots : -1;
}


// ---- the producer: bytes -> K[t] + W[t] ------------------------------------
// A block's bytes as loaded: 16 big-endian words read whole where the
// block lies inside an aligned row (`words`), else its 64 bytes one a
// register (0 past the message).  The loads of one fetch are issued
// together and used a fill later.
struct Fetched {
  uint32_t raw[64];
  bool words;
};

__device__ __forceinline__ void fetch_block(const uint8_t* __restrict__ row,
                                            long long len, long long b,
                                            bool aligned, Fetched& f) {
  const long long base = 64 * b;
  const bool inside = base + 64 <= len;
  f.words = aligned && inside;
  if (f.words) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + base);
#pragma unroll
    for (int j = 0; j < 16; ++j) f.raw[j] = __ldg(p + j);
  } else if (inside) {
#pragma unroll
    for (int i = 0; i < 64; ++i) f.raw[i] = __ldg(row + base + i);
  } else {
    // the message's last bytes, if any are left in this block
    const int left = len > base ? (int)(len - base) : 0;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      f.raw[i] = i < left ? (uint32_t)__ldg(row + base + i) : 0u;
  }
}

// The block's 16 message words, the padding made in place: 0x80 after the
// message's last byte, then zeros, and the bit length in the last 8 bytes
// of the last block.
__device__ __forceinline__ void block_words(const Fetched& f, long long len,
                                            long long b, uint32_t w[16]) {
  if (f.words) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = __byte_perm(f.raw[j], 0, 0x0123);
    return;
  }
  const long long base = 64 * b;
  const long long total = (len + 9 + 63) / 64 * 64;
  const unsigned long long bits = (unsigned long long)len * 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long i = base + 4 * j;
    uint32_t word = f.raw[4 * j] << 24 | f.raw[4 * j + 1] << 16 |
                    f.raw[4 * j + 2] << 8 | f.raw[4 * j + 3];
    const long long end = len - i;  // the 0x80 byte's place in this word
    if (end >= 0 && end < 4) word |= 0x80u << (8 * (3 - end));
    if (i == total - 8) word = (uint32_t)(bits >> 32);
    if (i == total - 4) word = (uint32_t)bits;
    w[j] = word;
  }
}

// The 48 scheduled words and K: kw[t * stride] = W[t] + K[t], t < 64.
__device__ __forceinline__ void expand_block(const uint32_t w_in[16],
                                             uint32_t* kw, int stride) {
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = w_in[j];
#pragma unroll
  for (int t = 0; t < kRounds; ++t) {
    if (t >= 16)
      w[t & 15] += small_sigma0(w[(t + 1) & 15]) + w[(t + 9) & 15] +
                   small_sigma1(w[(t + 14) & 15]);
    kw[t * stride] = w[t & 15] + kK[t];
  }
}

// All of the producer's work on block b of the message `row`: its K + W at
// kw[t * stride].
__device__ __forceinline__ void produce_block(const uint8_t* __restrict__ row,
                                              long long len, long long b,
                                              bool aligned, uint32_t* kw,
                                              int stride) {
  Fetched f;
  fetch_block(row, len, b, aligned, f);
  uint32_t w[16];
  block_words(f, len, b, w);
  expand_block(w, kw, stride);
}

// ---- the consumer: the rounds on K + W -------------------------------------
// x - y where the compiler cannot fold it back into the sum x was made
// from (a PTX sub is opaque to it).
__device__ __forceinline__ uint32_t opaque_sub(uint32_t x, uint32_t y) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("sub.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
#else
  return x - y;
#endif
}

// Eight rounds on the working state v (a ... h), K + W of each in kw.  The
// names rotate by one a round and come back after eight, so the rotation
// is in the indices, not in moves.  d + h + K + W does not depend on this
// round's e (h is e of three rounds back, d a of three rounds back): the
// new e is Sigma1(e) + Ch(e, f, g) + that, one 3-input add after the
// funnel shifts and their xor, the chain that pa_sha256_chain_clocks
// times.  The new a is T1 + Sigma0(a) + Maj(a, b, c) with T1 = new e - d,
// so that Sigma1(e) + Ch(e, f, g) is not summed on its own first (which
// puts a fourth step on the chain).
__device__ __forceinline__ void rounds8(uint32_t v[8], const uint32_t kw[8]) {
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    uint32_t &a = v[(8 - r) & 7], &b = v[(9 - r) & 7], &c = v[(10 - r) & 7],
             &d = v[(11 - r) & 7], &e = v[(12 - r) & 7], &f = v[(13 - r) & 7],
             &g = v[(14 - r) & 7], &h = v[(15 - r) & 7];
    const uint32_t dhkw = d + (h + kw[r]);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t e_new = big_sigma1(e) + ch + dhkw;
    h = opaque_sub(e_new, d) + (big_sigma0(a) + maj);  // the new a
    d = e_new;
  }
}

// One block's 64 rounds on the hash state st, K + W at kw[t * stride].
__device__ __forceinline__ void consume_block(uint32_t st[8],
                                              const uint32_t* kw, int stride) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
  for (int g = 0; g < kRounds / kGroup; ++g) {
    uint32_t cur[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) cur[r] = kw[(kGroup * g + r) * stride];
    rounds8(v, cur);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// ---- the kernel ---------------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kBarThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kBarThreads) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    sha256_kernel(const uint8_t* __restrict__ msg, int64_t* __restrict__ out,
                  long long lanes, long long len, long long blocks,
                  bool aligned) {
  __shared__ uint32_t ring[kSlots * kSlotWords];
  const int t = threadIdx.x % kWarp;
  const long long cta = blockIdx.x;
  const int L = cta_lanes(lanes, cta);
  const long long fills = ring_fills(blocks, L);
  if (threadIdx.x >= kWarp) {
    // a producer: thread t fills column t of its warp's fills; the bytes
    // of each fill are loaded while the fill before it is expanded
    const int pw = threadIdx.x / kWarp - 1;
    int lane;
    long long b;
    bool have = ring_pair(t, L, pw, blocks, &lane, &b);
    const uint8_t* row = msg + (cta * kWarp + lane) * len;
    Fetched bytes;
    bytes.words = false;
    if (have) fetch_block(row, len, b, aligned, bytes);
    for (long long f = pw; f < fills; f += kProducers) {
      uint32_t w[16];
      if (have) block_words(bytes, len, b, w);
      long long next_b;
      const bool next = ring_pair(t, L, f + kProducers, blocks, &lane, &next_b);
      if (next) fetch_block(row, len, next_b, aligned, bytes);
      const int s = ring_slot(f);
      __syncwarp();
      if (fill_reused(f) >= 0) bar_sync(kEmptyBar + s);
      if (have) expand_block(w, ring + s * kSlotWords + t, kWarp);
      __syncwarp();
      bar_arrive(kFullBar + s);
      have = next;
      b = next_b;
    }
    return;
  }
  // the consumer: thread t hashes lane t of the CTA, if there is one
  const bool active = t < L;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kH0[i];
  bar_sync(kFullBar + ring_slot(fill_awaited(0, L)));
  const uint32_t* src = ring + block_column(t, L, 0);
  uint32_t cur[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) cur[r] = active ? src[r * kWarp] : 0u;
  for (long long b = 0; b < blocks; ++b) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = st[i];
    uint32_t next[kGroup];
#pragma unroll 1
    for (int g = 1; g < kRounds / kGroup; ++g) {
      // K + W of the next eight rounds, read while these eight run
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        next[r] = active ? src[(kGroup * g + r) * kWarp] : 0u;
      rounds8(v, cur);
#pragma unroll
      for (int r = 0; r < kGroup; ++r) cur[r] = next[r];
    }
    // the last eight rounds: the next block's first eight come in
    // meanwhile, once its fill is in
    const bool more = b + 1 < blocks;
    if (more) {
      const long long awaited = fill_awaited(b + 1, L);
      if (awaited >= 0) bar_sync(kFullBar + ring_slot(awaited));
      src = ring + ring_slot(block_fill(b + 1, L)) * kSlotWords +
            block_column(t, L, b + 1);
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      next[r] = active && more ? src[r * kWarp] : 0u;
    rounds8(v, cur);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) cur[r] = next[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] += v[i];
    const long long released = fill_released(b, L, blocks);
    if (released >= 0) bar_arrive(kEmptyBar + ring_slot(released));
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[(cta * kWarp + t) * 8 + i] = (int64_t)st[i];
  }
}

// One thread: `reps` rounds of the chain each round's new e waits on
// (Sigma1 of e, then one 3-input add), between two clock64() reads.  The
// add's other terms come from memory, so nothing folds.
__global__ void chain_clocks_kernel(const uint32_t* __restrict__ in, int reps,
                                    long long* __restrict__ clocks,
                                    uint32_t* __restrict__ sink) {
  uint32_t e = in[0];
  const uint32_t x = in[1], y = in[2];
  const long long t0 = clock64();
  for (int r = 0; r < reps; r += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) e = big_sigma1(e) + x + (y ^ (uint32_t)u);
  }
  const long long t1 = clock64();
  clocks[0] = t1 - t0;
  sink[0] = e;
}

}  // namespace

extern "C" {

// SHA-256 of `lanes` messages of `len` bytes, row-major in `msg` (uint8),
// into `out` (lanes, 8) int64 digest words, `threads` threads a block (the
// kernel's two warps: any other count is refused).  `aligned`: the rows
// start on 4-byte boundaries (msg is 4-byte aligned and len a multiple of
// 4).
int pa_sha256(const uint8_t* msg, int64_t* out, long long lanes,
              long long len, int threads, int aligned, void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  if (threads != kThreads || len < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (len + 9 + 63) / 64;
  const long long grid = (lanes + kWarp - 1) / kWarp;
  sha256_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      msg, out, lanes, len, blocks, aligned != 0);
  return (int)cudaGetLastError();
}

// The clocks of `reps` (a multiple of 16) links of a round's critical
// chain on one thread: `in` three words, `clocks` one int64, `sink` one
// word, all on the device.
int pa_sha256_chain_clocks(const uint32_t* in, int reps, long long* clocks,
                           uint32_t* sink, void* stream) {
  if (reps <= 0 || reps % 16 != 0) return (int)cudaErrorInvalidValue;
  chain_clocks_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(in, reps, clocks,
                                                         sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
