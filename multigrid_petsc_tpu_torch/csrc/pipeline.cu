// KP3: the staged copy pipeline, for Hopper (sm_90a), bound through a plain
// C interface (ctypes).
//
// Replaces the kernels of benchmarks/probe_dma.py probe_c (one pallas_call
// that copies an n x n array k times through VMEM, (256, n) tiles double
// buffered by manual DMA) and benchmarks/probe_dma_parts.py variant (the
// compute-free visit pipeline: tiles with their halo rows in, carried
// halos, staged or direct u out, an rc stream out).  They measure what the
// card's asynchronous copy engine streams when the data passes through
// shared memory, against K18a's plain loads and stores (stream.cu); no
// solve runs them.
//
// The copy engine on Hopper: one thread asks for a flat range of global
// memory to be copied into shared memory (cp.async.bulk, 16-byte aligned
// addresses and sizes), and the hardware reports the bytes' arrival to an
// mbarrier in shared memory (its transaction count); the way back,
// shared to global, is a bulk copy tracked by bulk groups (commit_group,
// wait_group.read: the copy has read its shared memory).  Thread 0 of a
// block issues every bulk copy of the block; the other threads carry,
// stage and copy the heads and tails of rows that the aligned bulk copies
// leave (a row of 2^m - 1 f32 values starts 16-byte aligned only every
// fourth row).
//
// staged_copy: a ring of STAGES buffers of CHUNK f32 (32 KB) a block of
// one warp, BLOCKS_PER_SM blocks an SM, thread 0 issuing every bulk copy:
// LOOKAHEAD bulk loads in flight, the stores tracked by bulk groups (the
// buffer of item i + LOOKAHEAD - 1 last held item i + LOOKAHEAD - 1 -
// STAGES, whose store is STAGES - LOOKAHEAD groups back:
// wait_group.read STAGES - LOOKAHEAD before its load).  The core is dealt
// in rounds of one chunk a block, chunk b of each round to block b (the
// chunks in flight lie side by side, as a plain copy's lines do), and the
// last, short round in equal shares of 16-byte units, so that every block
// moves the same bytes.  Item i of a block is pass i / m, its chunk i % m
// (m items a pass).  Measured against two buffers with one load in
// flight (scripts/time_copies.py --variants): 3-6 stages of 16-32 KB, 1-6
// blocks an SM all run within 0.5% of it, and a contiguous span a block
// 5% slower; what keeps the staged copy ~5% behind y.copy_(x) lies in the
// bulk copies' path, not in how many are in flight.
//
// The visit pipeline: two buffers a block, a persistent block walking its
// tiles in order: tile i lands in buffer i & 1, whose mbarrier completes
// its phase once per use, so tile i waits on parity (i >> 1) & 1; before
// tile i + 1's load overwrites the other buffer, the bulk stores that read
// it (tile i - 1's) must have read it (wait_group.read).  So one load and
// one tile's stores are in flight a block at a time.
//
// What bounds them: bytes (no arithmetic).  staged_copy moves 2 n bytes a
// pass; the visit pipeline the tile rows in (with the halo rows where they
// are re-read), u out and, with rc, a quarter-size stream out.
//
// Sizes of the visit pipeline: a tile is t rows x TW = 256 columns (1 KB
// of f32 a row), HALO = 8 rows above and below, walked down a column strip
// by a block (a unit is SEG tiles of one strip, the units dealt round
// robin to the persistent blocks); a buffer row holds TW + 4 values, so
// that a row's 16-byte aligned core lands 16-byte aligned whatever the
// row's offset mod 4.  Shared memory is (2 (t + 2 HALO) + 2 t [staged u])
// (TW + 4) + 2 (t / 2) (TW / 2 + 4) [rc] f32: t = 32 takes 179 KB of
// the 227 KB a block may use; the TPU's (96-256, 8192) tiles do not fit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 8192;  // f32 entries a staged_copy chunk
constexpr int STAGES = 3;    // staged_copy's buffers a block
constexpr int LOOKAHEAD = 2;  // its bulk loads in flight
constexpr int BLOCKS_PER_SM = 2;
constexpr int TW = 256;      // columns of a visit-pipeline tile
constexpr int RW = TW + 4;   // a buffer row of it (alignment slack)
constexpr int RWC = TW / 2 + 4;  // an rc buffer row
constexpr int SEG = 8;       // tiles a unit (one block's walk down a strip)
constexpr int HALO = 8;      // rows above and below a tile (the TPU's H)
constexpr int VT = 256;      // threads of a visit-pipeline block
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One arrival a phase (thread 0's, with the phase's bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0's one arrival of a phase, with the bytes the phase's copies
// bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(saddr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// At most N of this thread's bulk groups still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Order this thread's generic-proxy accesses to shared memory before the
// bulk copies issued after the next barrier.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- staged_copy: o = u, k passes, one launch.  u and o hold n f32 and
// share their address mod 16; [h0, h0 + ncore) is the aligned core (ncore
// a multiple of 4), copied through shared memory; the head and the tail go
// by plain loads and stores (block 0).
__global__ void __launch_bounds__(32)
staged_copy_kernel(const float* __restrict__ u, float* __restrict__ o,
                   long long n, int k, long long h0, long long ncore) {
  static_assert(LOOKAHEAD >= 1 && LOOKAHEAD <= STAGES, "loads in flight");
  extern __shared__ __align__(128) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + STAGES * CHUNK * 4);
  if (blockIdx.x == 0)
    for (int p = 0; p < k; ++p)
      for (long long j = threadIdx.x; j < n - ncore; j += 32) {
        const long long g = j < h0 ? j : j + ncore;
        o[g] = u[g];
      }
  // `full` rounds of G chunks, then this block's share [lo, hi) of the
  // last round, in f32 entries from h0 (16-byte units: 4 entries).
  const long long G = gridDim.x, b = blockIdx.x;
  const long long full = ncore / (G * CHUNK);
  const long long units = (ncore - full * G * CHUNK) / 4;
  const long long lo = full * G * CHUNK + 4 * (units * b / G);
  const long long hi = full * G * CHUNK + 4 * (units * (b + 1) / G);
  const long long m = full + (hi > lo);
  const long long items = m * k;
  if (threadIdx.x != 0 || items == 0) return;
  for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s]);
  fence_mbar_init();
  auto start = [&](long long i) -> long long {
    const long long r = i % m;
    return h0 + (r < full ? (r * G + b) * CHUNK : lo);
  };
  auto bytes = [&](long long i) -> uint32_t {
    return (uint32_t)(4 * (i % m < full ? CHUNK : hi - lo));
  };
  auto load = [&](long long j) {
    const int s = (int)(j % STAGES);
    mbar_expect(&bar[s], bytes(j));
    bulk_load(buf + s * CHUNK, u + start(j), bytes(j), &bar[s]);
  };
  for (long long j = 0; j + 1 < LOOKAHEAD && j < items; ++j) load(j);
  for (long long i = 0; i < items; ++i) {
    if (i + LOOKAHEAD - 1 < items) {
      bulk_wait_read<STAGES - LOOKAHEAD>();
      load(i + LOOKAHEAD - 1);
    }
    const int s = (int)(i % STAGES);
    mbar_wait(&bar[s], (uint32_t)((i / STAGES) & 1));
    bulk_store(o + start(i), buf + s * CHUNK, bytes(i));
    bulk_commit();
  }
  bulk_wait_all();
}

// ---- The compute-free visit pipeline (probe_dma_parts.py variant).
struct Pipe {
  const float* b;
  float* u;
  float* rc;  // null: no rc stream
  int ny, nx, nyc, nxc, t;
  int strips, segs;  // column strips; units (tile groups) down a strip
  bool carry, staging;
};

// One tile: strip `strip`, rows [r0, r0 + rows); `first`: the first tile
// of its unit (nothing to carry).
struct Tile {
  int strip, r0, rows;
  bool first;
};

// A block's cursor over its units' tiles.
struct Cursor {
  int unit, tile;
};

__device__ __forceinline__ int unit_tiles(const Pipe& p, int unit) {
  const int g = unit % p.segs;  // the unit's place down its strip
  const int ntiles = (p.ny + p.t - 1) / p.t;
  const int left = ntiles - g * SEG;
  return left < SEG ? left : SEG;
}

__device__ __forceinline__ Tile tile_of(const Pipe& p, Cursor c) {
  const int r0 = ((c.unit % p.segs) * SEG + c.tile) * p.t;
  const int rows = p.ny - r0 < p.t ? p.ny - r0 : p.t;
  return Tile{c.unit / p.segs, r0, rows, c.tile == 0};
}

__device__ __forceinline__ Cursor advance(const Pipe& p, Cursor c) {
  if (++c.tile == unit_tiles(p, c.unit)) {
    c.tile = 0;
    c.unit += gridDim.x;
  }
  return c;
}

// A row segment of `w` values at global index g of a 16-byte aligned base:
// its offset mod 4 (`pad`, where its value 0 sits in a buffer row), its
// head (values before the aligned core) and the core's length.
struct Seg {
  int pad, head, core, w;
};

__device__ __forceinline__ Seg seg_of(long long g, int w) {
  const int pad = (int)(g & 3);
  const int head = min((4 - pad) & 3, w);
  return Seg{pad, head, (w - head) & ~3, w};
}

// Buffer rows [qa, qb) of tile `tl` from b: thread 0 issues the aligned
// cores as bulk copies on `bar` (and arrives with their bytes); every
// thread copies heads and tails by plain loads.
__device__ void load_rows(const Pipe& p, const Tile& tl, float* buf,
                          uint64_t* bar, int qa, int qb) {
  const int c0 = tl.strip * TW;
  const int w = min(TW, p.nx - c0);
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int q = qa; q < qb; ++q) {
      const long long g = (long long)(tl.r0 - HALO + q) * p.nx + c0;
      total += 4u * (uint32_t)seg_of(g, w).core;
    }
    mbar_expect(bar, total);
    for (int q = qa; q < qb; ++q) {
      const long long g = (long long)(tl.r0 - HALO + q) * p.nx + c0;
      const Seg s = seg_of(g, w);
      if (s.core > 0)
        bulk_load(buf + q * RW + s.pad + s.head, p.b + g + s.head,
                  4u * s.core, bar);
    }
  }
  for (int x = threadIdx.x; x < (qb - qa) * 8; x += VT) {
    const int q = qa + (x >> 3), e = x & 7;
    const long long g = (long long)(tl.r0 - HALO + q) * p.nx + c0;
    const Seg s = seg_of(g, w);
    const int j = e < 4 ? e : s.head + s.core + (e - 4);
    if ((e < 4 && j < s.head) || (e >= 4 && j < w))
      buf[q * RW + s.pad + j] = p.b[g + j];
  }
}

// The buffer rows a tile loads: those of [r0 - HALO, r0 + rows + HALO)
// inside the domain, past the 2 HALO carried ones where `carried`.
__device__ __forceinline__ void load_range(const Pipe& p, const Tile& tl,
                                           bool carried, int& qa, int& qb) {
  qa = max(carried ? 2 * HALO : 0, HALO - tl.r0);
  qb = min(tl.rows + 2 * HALO, p.ny - tl.r0 + HALO);
}

// Rows [0, n) of a buffer to rows of `dst` (row i at global index g(i)):
// thread 0 the aligned cores as bulk stores (one group, committed by the
// caller), every thread the heads and tails by plain stores.
template <class G>
__device__ void store_rows(const float* buf, int rw, float* dst, int n,
                           int w, G g_of) {
  if (threadIdx.x == 0)
    for (int i = 0; i < n; ++i) {
      const long long g = g_of(i);
      const Seg s = seg_of(g, w);
      if (s.core > 0)
        bulk_store(dst + g + s.head, buf + i * rw + s.pad + s.head,
                   4u * s.core);
    }
  for (int x = threadIdx.x; x < n * 8; x += VT) {
    const int i = x >> 3, e = x & 7;
    const long long g = g_of(i);
    const Seg s = seg_of(g, w);
    const int j = e < 4 ? e : s.head + s.core + (e - 4);
    if ((e < 4 && j < s.head) || (e >= 4 && j < w))
      dst[g + j] = buf[i * rw + s.pad + j];
  }
}

__global__ void __launch_bounds__(VT)
staged_pipe_kernel(Pipe p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int BR = p.t + 2 * HALO;  // rows of an input buffer
  float* bbuf = reinterpret_cast<float*>(smem);
  float* ubuf = bbuf + 2 * BR * RW;
  float* rcbuf = ubuf + (p.staging ? 2 * p.t * RW : 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      rcbuf + (p.rc != nullptr ? 2 * (p.t / 2) * RWC : 0));
  const int units = p.strips * p.segs;
  if ((int)blockIdx.x >= units) return;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    fence_mbar_init();
  }
  __syncthreads();
  Cursor cur{(int)blockIdx.x, 0};
  Tile tl = tile_of(p, cur);
  int qa, qb;
  load_range(p, tl, false, qa, qb);
  load_rows(p, tl, bbuf, &bar[0], qa, qb);
  __syncthreads();
  for (long long i = 0;; ++i) {
    const int s = (int)(i & 1);
    float* bs = bbuf + s * BR * RW;
    const Cursor nc = advance(p, cur);
    const bool more = nc.unit < units;
    mbar_wait(&bar[s], (uint32_t)((i >> 1) & 1));
    if (more) {
      // Buffer s ^ 1 takes the next tile: item i - 1's reads of it are
      // done (its fill before the last barrier; its direct u stores here).
      if (!p.staging && threadIdx.x == 0) bulk_wait_read<0>();
      fence_async();
      __syncthreads();
      const Tile nt = tile_of(p, nc);
      float* bn = bbuf + (s ^ 1) * BR * RW;
      const bool carried = p.carry && !nt.first;
      if (carried)  // the next tile's top 2 HALO rows are this one's last
        for (int x = threadIdx.x; x < 2 * HALO * RW; x += VT)
          bn[x] = bs[p.t * RW + x];
      load_range(p, nt, carried, qa, qb);
      load_rows(p, nt, bn, &bar[s ^ 1], qa, qb);
    }
    const int c0 = tl.strip * TW;
    const int w = min(TW, p.nx - c0);
    const int nI = min(tl.rows / 2, p.nyc - tl.r0 / 2);
    const int nJ = min(w / 2, p.nxc - c0 / 2);
    if (p.staging || p.rc != nullptr) {
      // Item i - 2's stores have read ubuf / rcbuf s.
      if (threadIdx.x == 0) bulk_wait_read<1>();
      __syncthreads();
      if (p.staging) {
        float* us = ubuf + s * p.t * RW;
        for (int x = threadIdx.x; x < tl.rows * RW; x += VT)
          us[x] = bs[HALO * RW + x];
      }
      if (p.rc != nullptr) {
        float* rs = rcbuf + s * (p.t / 2) * RWC;
        for (int x = threadIdx.x; x < nI * nJ; x += VT) {
          const int i2 = x / nJ, j = x % nJ;
          const long long gr = (long long)(tl.r0 + 2 * i2 + 1) * p.nx + c0;
          const long long gc =
              (long long)(tl.r0 / 2 + i2) * p.nxc + c0 / 2;
          rs[i2 * RWC + (int)(gc & 3) + j] =
              bs[(HALO + 2 * i2 + 1) * RW + (int)(gr & 3) + 2 * j + 1];
        }
      }
    }
    fence_async();
    __syncthreads();
    // The stores: u's tile rows from the staging buffer or straight from
    // the input buffer; rc's rows.
    const float* usrc = p.staging ? ubuf + s * p.t * RW : bs + HALO * RW;
    store_rows(usrc, RW, p.u, tl.rows, w, [&](int r) {
      return (long long)(tl.r0 + r) * p.nx + c0;
    });
    if (p.rc != nullptr)
      store_rows(rcbuf + s * (p.t / 2) * RWC, RWC, p.rc, nI, nJ, [&](int r) {
        return (long long)(tl.r0 / 2 + r) * p.nxc + c0 / 2;
      });
    if (threadIdx.x == 0) bulk_commit();
    if (!more) break;
    cur = nc;
    tl = tile_of(p, cur);
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// The shared memory of a visit-pipeline block with tile rows t
// (staging: a u staging buffer; rc: an rc buffer).
size_t pipe_smem(int t, int staging, int rc) {
  const size_t in = 2 * (size_t)(t + 2 * HALO) * RW;
  const size_t up = staging ? 2 * (size_t)t * RW : 0;
  const size_t rcb = rc ? 2 * (size_t)(t / 2) * RWC : 0;
  return 4 * (in + up + rcb) + 16;  // the f32 buffers, two mbarriers
}

// A grid of whole SMs' worth of resident blocks (at most `per_sm` an SM
// where given), no more than `work`.
int grid_for(const void* kern, int threads, size_t smem, long long work,
             int* blocks, int per_sm = 0) {
  int dev = 0, sms = 0, per = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern,
                                                             threads, smem);
  if (err) return err;
  if (per < 1) return (int)cudaErrorInvalidValue;
  if (per_sm > 0 && per_sm < per) per = per_sm;
  const long long want = (long long)sms * per;
  *blocks = (int)(work < want ? (work < 1 ? 1 : work) : want);
  return 0;
}

}  // namespace

extern "C" {

// o = u over n f32 entries, k passes in one launch (u and o share their
// address mod 16, both 4-byte aligned).
int mg_staged_copy(const float* u, float* o, long long n, int k,
                   void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(u);
  if (n < 1 || k < 1 || ((a ^ reinterpret_cast<uintptr_t>(o)) & 15) ||
      (a & 3))
    return (int)cudaErrorInvalidValue;
  const long long h0 = ((16 - (long long)(a & 15)) & 15) / 4;
  const long long head = h0 < n ? h0 : n;
  const long long ncore = (n - head) & ~3LL;
  const size_t smem = (size_t)STAGES * CHUNK * 4 + 8 * STAGES;
  int blocks = 1;
  int err = grid_for((const void*)staged_copy_kernel, 32, smem,
                     (ncore + CHUNK - 1) / CHUNK, &blocks, BLOCKS_PER_SM);
  if (err) return err;
  staged_copy_kernel<<<blocks, 32, smem, (cudaStream_t)stream>>>(
      u, o, n, k, head, ncore);
  return (int)cudaGetLastError();
}

// The visit pipeline over b (ny x nx f32, 16-byte aligned): u = b and,
// where rc is not null, rc = b's odd-odd points ((ny - 1) / 2 x (nx - 1)
// / 2); tiles of t rows (even) x 256 columns with halos of HALO rows, SEG
// tiles a unit; carry: the halo rows kept from the tile above; staging:
// u written from a staging buffer (else from the input buffer).
int mg_staged_pipe(const float* b, float* u, float* rc, int ny, int nx,
                   int t, int carry, int staging, void* stream) {
  if (ny < 3 || nx < 3 || t < 2 || (t & 1) ||
      ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(u) |
        reinterpret_cast<uintptr_t>(rc)) &
       15))
    return (int)cudaErrorInvalidValue;
  const size_t smem = pipe_smem(t, staging, rc != nullptr);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  Pipe p{b,  u,  rc, ny,  nx,  (ny - 1) / 2, (nx - 1) / 2, t,
         (nx + TW - 1) / TW, 0, carry != 0, staging != 0};
  const int ntiles = (ny + t - 1) / t;
  p.segs = (ntiles + SEG - 1) / SEG;
  int blocks = 1;
  int err = grid_for((const void*)staged_pipe_kernel, VT, smem,
                     (long long)p.strips * p.segs, &blocks);
  if (err) return err;
  staged_pipe_kernel<<<blocks, VT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
