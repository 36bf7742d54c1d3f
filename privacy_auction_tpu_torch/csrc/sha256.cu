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
// Design: one thread a message.  The thread walks its ceil((L + 9) / 64)
// blocks, building each block's 16 big-endian words from its row's bytes
// and making the padding (0x80, zeros, the 64-bit bit length) in place, so
// the caller passes the (B, L) uint8 messages as they are.  The 64 rounds
// are unrolled, the message schedule is a 16-word window in registers,
// rotations are funnel shifts, K sits in constant memory.  The next
// block's words are loaded before the current block is compressed, so a
// long message (one lane, CCS22's evaluator) does not wait for memory
// between blocks.  The digest is written as (B, 8) int64 words, the plain
// version's layout.
//
// What bounds it: 32-bit integer operations (cuda_ec.SHA256_OPS_PER_BLOCK
// a block) at batches that fill the card; below that, and always for one
// long message, a lane's chain of rounds: each round's new e waits on the
// old e through Sigma1 (funnel shifts, one 3-input xor) and one 3-input
// add.  `pa_sha256_chain_clocks` measures that chain's clocks on the card.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}

// Block `b` of the padded message `row` of `len` bytes, as 16 big-endian
// words.  A block that lies inside the message is read as it is (whole
// 32-bit words where `aligned`: every row starts on a 4-byte boundary);
// the last one or two blocks hold the padding, made here byte by byte.
__device__ __forceinline__ void load_block(const uint8_t* __restrict__ row,
                                           long long len, long long b,
                                           bool aligned, uint32_t w[16]) {
  const long long base = 64 * b;
  if (base + 64 <= len) {
    if (aligned) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(row + base);
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = __byte_perm(__ldg(p + j), 0, 0x0123);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint8_t* p = row + base + 4 * j;
        w[j] = (uint32_t)__ldg(p) << 24 | (uint32_t)__ldg(p + 1) << 16 |
               (uint32_t)__ldg(p + 2) << 8 | (uint32_t)__ldg(p + 3);
      }
    }
    return;
  }
  // the padded tail: message bytes, 0x80, zeros, then the bit length in
  // the last 8 bytes of the last block
  const long long total = (len + 9 + 63) / 64 * 64;
  const unsigned long long bits = (unsigned long long)len * 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = base + 4 * j + k;
      uint32_t byte;
      if (i < len) {
        byte = __ldg(row + i);
      } else if (i == len) {
        byte = 0x80u;
      } else if (i >= total - 8) {
        byte = (uint32_t)(bits >> (8 * (total - 1 - i))) & 0xFFu;
      } else {
        byte = 0;
      }
      word = word << 8 | byte;
    }
    w[j] = word;
  }
}

// One block: the 64 rounds on the state, the message schedule in the
// 16-word window w (overwritten).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    // h + K + W and d + h + K + W do not depend on this round's e or a:
    // the new e is Sigma1(e) + Ch(e, f, g) + that, one 3-input add
    const uint32_t hkw = h + kK[t] + wt;
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t s1 = big_sigma1(e);
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t1 = s1 + ch + hkw;
    h = g;
    g = f;
    f = e;
    e = s1 + ch + (d + hkw);
    d = c;
    c = b;
    b = a;
    a = t1 + (s0 + maj);
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

__global__ void sha256_kernel(const uint8_t* __restrict__ msg,
                              int64_t* __restrict__ out, long long lanes,
                              long long len, long long blocks, bool aligned) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const uint8_t* row = msg + lane * len;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kH0[i];
  uint32_t w[16];
  load_block(row, len, 0, aligned, w);
  for (long long b = 0; b < blocks; ++b) {
    uint32_t next[16];
    if (b + 1 < blocks) load_block(row, len, b + 1, aligned, next);
    compress(st, w);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = next[j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[lane * 8 + i] = (int64_t)st[i];
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
// into `out` (lanes, 8) int64 digest words, `threads` threads a block.
// `aligned`: the rows start on 4-byte boundaries (msg is 4-byte aligned and
// len a multiple of 4).
int pa_sha256(const uint8_t* msg, int64_t* out, long long lanes,
              long long len, int threads, int aligned, void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  if (threads <= 0 || threads > 1024 || threads % 32 != 0 || len < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (len + 9 + 63) / 64;
  const long long grid = (lanes + threads - 1) / threads;
  sha256_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
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
