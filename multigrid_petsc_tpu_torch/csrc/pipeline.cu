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
// wait_group.read: the copy has read its shared memory).
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
// What bounds them: bytes (no arithmetic).  staged_copy moves 2 n bytes a
// pass; the visit pipeline the tile rows in (with the halo rows where they
// are re-read), u out and, with rc, a quarter-size stream out.
//
// The visit pipeline (redesigned for Hopper; it replaces a design of two
// tile buffers a block of 256 threads, thread 0 issuing every bulk copy of
// a tile in series, one load in flight, the carried halo copied shared to
// shared and the fill, the rc gather and the stores run in turn between
// block barriers: 34% of its bound in v_full).  A tile is t rows x TW =
// 256 columns (1 KB of f32 a row) with HALO = 8 rows above and below: the
// window of t + 2 HALO rows a visit reads.  A block is one producer warp
// and PIPE_WARPS consumer warps on a ring of row stages:
//
// - the producer issues every load, its lanes a row each in parallel: the
//   row's 16-byte aligned core by one 1-D cp.async.bulk, its 0-3 values
//   of head and tail by 4-byte cp.async copies (a row of 2^m - 1 f32
//   values starts 16-byte aligned only every fourth row, so no 2-D tensor
//   map spans the array; plain loads there hold the producer a memory
//   latency a value: 1.2-1.7x the time, scripts/pipeline_trials.py).  It
//   completes the tile's `full` barrier with one arrive.expect_tx of the
//   window's bytes (a warp sum) and one arrival a lane when its cp.async
//   copies land;
// - the ring holds `stages` (3-6, the most that fit) tiles' rows; ring row
//   v holds window row q of the tile whose window starts at virtual row
//   vb where v = (vb + q) % nr.  A carried tile's window starts t rows
//   below its predecessor's, so the 2 HALO rows they share stay where they
//   landed (no copy) and only t rows are loaded; without the carry, or at
//   a unit's first tile, the whole window is loaded into fresh rows.  The
//   producer loads a tile once every tile whose window starts a lap (nr
//   rows) before this window's end has released its rows on its `empty`
//   barrier (one arrival a consumer warp), and the tile `stages` back has
//   (its barriers): stages - 1 loads are in flight while a tile is
//   consumed;
// - the consumer warps take the tile's rows (row i to warp i % PIPE_WARPS)
//   with 16-byte vectors: the staging fill (a buffer row of RW = TW + 4
//   floats starts 16-byte aligned, its core at the same place as in the
//   ring), the rc gather (one aligned float2 read a value, the row's
//   offsets once a row: no divide, no bank conflict) and the stores,
//   plain 16-byte stores (rc by 4-byte coalesced stores), which release
//   the ring's rows as soon as they are read.  Bulk stores (one thread a
//   row, their wait_group.read ahead of the buffers' refill and of the
//   ring rows' release) ran up to 19% slower (median 4%; a tie only in
//   v_bare at t = 16; PERF.md §6), and the evict-first hint on the plain
//   stores 0.5-3% slower (scripts/pipeline_trials.py): neither is kept.
//
// The work: each column strip is cut into `bands` bands of row pairs
// (about BAND_TILES tiles high; their count a multiple of blocks / gcd
// (blocks, strips), so that every block of a full grid walks as many), the
// units band-major (unit u: band u / strips of strip u % strips), dealt
// round robin to the persistent blocks, each unit walked top to bottom in
// tiles of t rows (the last shorter) with the carry.  So the blocks at
// work at once hold neighbouring strips of the same rows, as a plain
// copy's lines lie side by side (a first build that gave each block one
// span down a strip ran slower).  Shared
// memory: a ring of nr = stages t + 2 HALO rows of RW f32 (stages (t + 2
// HALO) without the carry), t rows of staged u and the barriers: v_full
// at t = 32 takes 216 KB of the 227 KB a block may use (5 stages); the
// TPU's (96-256, 8192) tiles do not fit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 8192;  // f32 entries a staged_copy chunk
constexpr int STAGES = 3;    // staged_copy's buffers a block
constexpr int LOOKAHEAD = 2;  // its bulk loads in flight
constexpr int BLOCKS_PER_SM = 2;
constexpr int TW = 256;      // columns of a visit-pipeline tile
constexpr int RW = TW + 4;   // a ring or buffer row of it (alignment slack)
constexpr int HALO = 8;      // rows above and below a tile (the TPU's H)
constexpr int PIPE_WARPS = 8;  // consumer warps of a visit-pipeline block
constexpr int PIPE_THREADS = 288;  // and its producer warp
constexpr int PIPE_STAGES = 6;  // most stages of its ring
constexpr int PIPE_MIN_STAGES = 3;  // fewest: two loads in flight
constexpr int BAND_TILES = 8;  // tiles of a band (a block's unit) at most
constexpr size_t MAX_SMEM = 232448;
static_assert(PIPE_THREADS == 32 * (PIPE_WARPS + 1), "one producer warp");

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `count` arrivals a phase (staged_copy: thread 0's, with the phase's
// bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar,
                                          uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
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

// A 4-byte copy global to shared by the copy engine's older path
// (cp.async), landing asynchronously: no wait for the load.
__device__ __forceinline__ void async_load4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr(dst)),
               "l"(src)
               : "memory");
}

// An arrival on `bar` once this thread's cp.async copies issued so far
// have landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   saddr(bar))
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
  int strips, pp;  // column strips; row pairs a strip
  int bands, units;  // bands of row pairs a strip; strips x bands units
  int stages, nr;  // the ring's stages (tiles) and rows
  bool carry, staging;
};

// A tile of a block's walk: unit u (band u / strips of strip u % strips,
// its rows [r0 of its first tile, end)), rows [r0, r0 + rows); its window
// (rows r0 - HALO + q, q in [0, t + 2 HALO)) in ring rows (vb + q) % nr;
// `fresh`: it loads its whole window (a unit's first tile, or no carry),
// else rows q >= 2 HALO.
struct Cursor {
  int u, vb, strip, r0, rows, end;
  bool fresh;
};

// Place c at the first tile of its unit c.u.
__device__ __forceinline__ void place(const Pipe& P, Cursor& c) {
  const int band = c.u / P.strips;
  c.strip = c.u - band * P.strips;
  c.r0 = 2 * (int)((long long)band * P.pp / P.bands);
  c.end = min(P.ny, 2 * (int)((long long)(band + 1) * P.pp / P.bands));
  c.rows = min(P.t, c.end - c.r0);
  c.fresh = true;
}

__device__ __forceinline__ Cursor first_tile(const Pipe& P) {
  Cursor c{(int)blockIdx.x, 0, 0, 0, 0, 0, true};
  place(P, c);
  return c;
}

// Step c to the next tile of the walk (the units b, b + G, ... of block b
// of G, each top to bottom); false past its last.  A tile below another of
// its unit is carried: its window starts t ring rows on, where the shared
// 2 HALO rows are; a fresh one starts past the last window.
__device__ __forceinline__ bool next_tile(const Pipe& P, Cursor& c) {
  if (c.r0 + c.rows < c.end) {
    c.r0 += c.rows;
    c.rows = min(P.t, c.end - c.r0);
    c.fresh = !P.carry;
  } else {
    c.u += gridDim.x;
    if (c.u >= P.units) return false;
    place(P, c);
  }
  c.vb += c.fresh ? P.t + 2 * HALO : P.t;
  return true;
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

// The producer warp's loads of tile c's window into the ring: lane l the
// rows lo + l, lo + l + 32, ... (the core by one bulk copy on `full`, the
// head and tail by 4-byte cp.async copies); lane 0's arrive.expect_tx
// brings the window's bytes (summed over the lanes) ahead of the copies,
// and every lane's arrival comes when its 4-byte copies have landed.  No
// lane waits for a load: a plain load of the heads and tails would hold
// the producer a memory latency a value.
__device__ void load_tile(const Pipe& P, const Cursor& c, float* ring,
                          uint64_t* full, int lane) {
  const int c0 = c.strip * TW, w = min(TW, P.nx - c0);
  const int lo = c.fresh ? max(0, HALO - c.r0) : 2 * HALO;
  const int hi = min(c.rows + 2 * HALO, P.ny - c.r0 + HALO);
  const long long g0 = (long long)(c.r0 - HALO) * P.nx + c0;
  uint32_t bytes = 0;
  for (int q = lo + lane; q < hi; q += 32)
    bytes += 4u * (uint32_t)seg_of(g0 + (long long)q * P.nx, w).core;
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) mbar_expect(full, bytes);
  __syncwarp();
  for (int q = lo + lane; q < hi; q += 32) {
    const long long g = g0 + (long long)q * P.nx;
    const Seg s = seg_of(g, w);
    float* row = ring + (size_t)((c.vb + q) % P.nr) * RW + s.pad;
    if (s.core > 0)
      bulk_load(row + s.head, P.b + g + s.head, 4u * s.core, full);
    for (int j = 0; j < s.head; ++j) async_load4(row + j, P.b + g + j);
    for (int j = s.head + s.core; j < w; ++j)
      async_load4(row + j, P.b + g + j);
  }
  async_arrive(full);
}

// Value e of a ring or buffer row (16-byte aligned) by an aligned float2.
__device__ __forceinline__ float pick(const float* row, int e) {
  const float2 v = *reinterpret_cast<const float2*>(row + (e & ~1));
  return (e & 1) ? v.y : v.x;
}

// One row of u from `src` (a ring or staging row, value j at s.pad + j):
// the core by 16-byte vectors of the lanes, the head and tail by lanes 0-7.
__device__ __forceinline__ void store_row(const float* src, float* dst,
                                          const Seg& s, int lane) {
  const float4* sv = reinterpret_cast<const float4*>(src + s.pad + s.head);
  float4* dv = reinterpret_cast<float4*>(dst + s.head);
  for (int m = lane; m < s.core / 4; m += 32) dv[m] = sv[m];
  const int e = lane < 4 ? lane : s.head + s.core + lane - 4;
  if (lane < 4 ? e < s.head : lane < 8 && e < s.w)
    dst[e] = src[s.pad + e];
}

__global__ void __launch_bounds__(PIPE_THREADS)
staged_pipe_kernel(Pipe P) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* ubuf = ring + (size_t)P.nr * RW;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ubuf + (P.staging ? P.t * RW : 0));
  uint64_t* empty = full + PIPE_STAGES;
  if ((int)blockIdx.x >= P.units) return;
  const int S = P.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);  // lane 0's expect_tx and 32 lanes'
      mbar_init(&empty[s], PIPE_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == PIPE_WARPS) {  // the producer
    Cursor ld = first_tile(P), fr = ld;  // fr: tile f
    for (int j = 0, f = 0;; ++j) {
      // Tiles f, f + 1, ... done (released) until tile j's window has its
      // rows and its barriers free.
      const int lap = ld.vb + P.t + 2 * HALO - P.nr;
      while (f < j && (j - f >= S || fr.vb < lap)) {
        mbar_wait(&empty[f % S], (uint32_t)((f / S) & 1));
        next_tile(P, fr);
        ++f;
      }
      load_tile(P, ld, ring, &full[j % S], lane);
      if (!next_tile(P, ld)) return;
    }
  }
  Cursor c = first_tile(P);
  for (int k = 0;; ++k) {
    const int s = k % S;
    mbar_wait(&full[s], (uint32_t)((k / S) & 1));
    const int c0 = c.strip * TW, w = min(TW, P.nx - c0);
    const int nI = min(c.rows / 2, P.nyc - c.r0 / 2);
    const int nJ = min(w / 2, P.nxc - c0 / 2);
    const long long gu = (long long)c.r0 * P.nx + c0;  // u's row 0
    const long long gc = (long long)(c.r0 / 2) * P.nxc + c0 / 2;  // rc's
    auto ring_row = [&](int i) {  // tile row i
      return ring + (size_t)((c.vb + HALO + i) % P.nr) * RW;
    };
    // Reads of the ring: the staging fill, the rc gather.
    if (P.staging)
      for (int i = warp; i < c.rows; i += PIPE_WARPS) {
        const float4* src = reinterpret_cast<const float4*>(ring_row(i));
        float4* dst = reinterpret_cast<float4*>(ubuf + i * RW);
        for (int m = lane; m < RW / 4; m += 32) dst[m] = src[m];
      }
    if (P.rc != nullptr)
      for (int i2 = warp; i2 < nI; i2 += PIPE_WARPS) {
        const float* row = ring_row(2 * i2 + 1);
        // b's column c0 + 2 j + 1 sits at e0 + 2 j of the ring row.
        const int e0 = (int)((gu + (2LL * i2 + 1) * P.nx) & 3) + 1;
        const long long g = gc + (long long)i2 * P.nxc;
        for (int j = lane; j < nJ; j += 32)
          P.rc[g + j] = pick(row, e0 + 2 * j);
      }
    __syncwarp();
    if (P.staging && lane == 0) mbar_arrive(&empty[s]);
    for (int i = warp; i < c.rows; i += PIPE_WARPS) {
      const long long g = gu + (long long)i * P.nx;
      store_row(P.staging ? ubuf + i * RW : ring_row(i), P.u + g,
                seg_of(g, w), lane);
    }
    __syncwarp();
    if (!P.staging && lane == 0) mbar_arrive(&empty[s]);
    if (!next_tile(P, c)) return;
  }
}

// Rows of the visit pipeline's ring with tile rows t.
int ring_rows(int t, int stages, int carry) {
  return carry ? stages * t + 2 * HALO : stages * (t + 2 * HALO);
}

// The shared memory of a visit-pipeline block (staging: a u staging
// buffer).
size_t pipe_smem(int t, int stages, int carry, int staging) {
  const size_t ring = (size_t)ring_rows(t, stages, carry) * RW;
  const size_t up = staging ? (size_t)t * RW : 0;
  return 4 * (ring + up) + 16 * PIPE_STAGES;  // + full, empty
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

// Bands of a column strip: about BAND_TILES tiles high, their count a
// multiple of blocks / gcd(blocks, strips) where that adds at most half
// again (then every block of a whole grid walks as many units), at most
// one a row pair.
int bands_for(int ny, int strips, int t, int blocks) {
  int a = blocks, b = strips;
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int q = blocks / a;
  const int want = (ny + BAND_TILES * t - 1) / (BAND_TILES * t);
  const int even = (want + q - 1) / q * q;
  const int bands = 2 * even <= 3 * want ? even : want;
  return bands < (ny + 1) / 2 ? bands : (ny + 1) / 2;
}

// The visit pipeline's plan: its arguments checked, its shared memory,
// its bands and its grid (whole SMs of resident blocks, no more than the
// units).
int pipe_plan(int ny, int nx, int t, int stages, int carry, int staging,
              size_t* smem, int* bands, int* blocks) {
  const int strips = (nx + TW - 1) / TW;
  if (ny < 3 || nx < 3 || t < 2 * HALO || (t & 1) ||
      stages < PIPE_MIN_STAGES || stages > PIPE_STAGES ||
      (long long)strips * ((ny + 1) / 2) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  *smem = pipe_smem(t, stages, carry, staging);
  if (*smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int resident = 0;
  int err = grid_for((const void*)staged_pipe_kernel, PIPE_THREADS, *smem,
                     INT32_MAX, &resident);
  if (err) return err;
  *bands = bands_for(ny, strips, t, resident);
  *blocks = min(resident, strips * *bands);
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
// / 2); tiles of t rows (even, >= 2 HALO) x 256 columns with halos of HALO
// rows through a ring of `stages` tiles; carry: the halo rows kept from
// the tile above; staging: u written from a staging buffer (else from the
// ring).
int mg_staged_pipe(const float* b, float* u, float* rc, int ny, int nx,
                   int t, int stages, int carry, int staging, void* stream) {
  if ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(u) |
       reinterpret_cast<uintptr_t>(rc)) &
      15)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int bands = 1, blocks = 1;
  const int err = pipe_plan(ny, nx, t, stages, carry, staging, &smem, &bands,
                            &blocks);
  if (err) return err;
  const int strips = (nx + TW - 1) / TW;
  const Pipe p{b,      u,      rc,     ny,     nx,
               (ny - 1) / 2, (nx - 1) / 2, t, strips, (ny + 1) / 2,
               bands,  strips * bands, stages, ring_rows(t, stages, carry),
               carry != 0, staging != 0};
  staged_pipe_kernel<<<blocks, PIPE_THREADS, smem, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}

// The plan mg_staged_pipe launches with these arguments: plan[0] its
// grid, plan[1] its bands a strip; or an error.
int mg_staged_pipe_plan(int ny, int nx, int t, int stages, int carry,
                        int staging, int* plan) {
  size_t smem = 0;
  return pipe_plan(ny, nx, t, stages, carry, staging, &smem, &plan[1],
                   &plan[0]);
}

}  // extern "C"
