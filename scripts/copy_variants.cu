// Trial designs of the two copies that lose to one PyTorch call, timed in
// turns by scripts/time_copies.py --variants (built there with nvcc into a
// library of its own, beside the package's; f32, 16-byte aligned pointers,
// n a multiple of 4: the trials' shapes).
//
// K18a, o = a u (csrc/stream.cu scale_copy_kernel):
//   copy_tile<HINT, VPT, UNROLL, INPLACE>  one block of 256 threads a tile
//       of UNROLL x 256 x VPT 16-byte vectors (VPT adjacent vectors a
//       thread a step: 16 or 32 bytes), a block a tile as the package's
//       kernel (INPLACE: o <- a o, KP2);
//   copy_span<HINT, VPT, UNROLL>  whole waves of persistent blocks, each
//       walking a contiguous span of the array in such steps;
//   HINT 0 plain loads and stores, 1 __ldcs / __stcs (evict first), 2
//       ld.global.nc.L1::no_allocate loads with __stcs stores.
// KP3, the staged copy (csrc/pipeline.cu staged_copy_kernel):
//   ring_copy<S, P, CHUNK, ROUNDS>  one-warp blocks, thread 0 issuing: a
//       ring of S shared buffers of CHUNK bytes, P bulk loads in flight
//       (P <= S), k passes; each block a contiguous span of 16-byte units
//       (ROUNDS false) or, in rounds of one chunk a block, chunk b of each
//       round and an equal share of the last, short round in 16-byte
//       units (ROUNDS true); HINT: an evict-first L2 policy on every bulk
//       copy; MODE 1 the bulk loads alone, 2 the bulk stores alone (the
//       two halves of the copy, timed beside x.sum() and y.zero_()).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;

template <int HINT>
__device__ __forceinline__ float4 load16(const float4* p) {
  if constexpr (HINT == 0) {
    return *p;
  } else if constexpr (HINT == 1) {
    return __ldcs(p);
  } else {
    float4 v;
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p));
    return v;
  }
}

template <int HINT>
__device__ __forceinline__ void store16(float4* p, float4 v) {
  if constexpr (HINT == 0)
    *p = v;
  else
    __stcs(p, v);
}

__device__ __forceinline__ float4 scale(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

// The vectors [j0, j0 + UNROLL x NT x VPT) of a step: thread t takes VPT
// adjacent vectors at j0 + (k NT + t) VPT, k < UNROLL.
template <int HINT, int VPT, int UNROLL, bool GUARD>
__device__ __forceinline__ void step(const float4* u, float4* o,
                                     long long j0, long long hi, float a) {
  float4 x[UNROLL][VPT];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const long long j = j0 + ((long long)k * NT + threadIdx.x) * VPT + v;
      if (!GUARD || j < hi) x[k][v] = load16<HINT>(u + j);
    }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const long long j = j0 + ((long long)k * NT + threadIdx.x) * VPT + v;
      if (!GUARD || j < hi) store16<HINT>(o + j, scale(x[k][v], a));
    }
}

template <int HINT, int VPT, int UNROLL, bool INPLACE>
__global__ void __launch_bounds__(NT)
copy_tile(const float4* u, float4* o, long long nv, float a) {
  constexpr long long TILE = (long long)UNROLL * NT * VPT;
  for (long long t = blockIdx.x; t * TILE < nv; t += gridDim.x)
    step<HINT, VPT, UNROLL, true>(INPLACE ? o : u, o, t * TILE, nv, a);
}

template <int HINT, int VPT, int UNROLL>
__global__ void __launch_bounds__(NT)
copy_span(const float4* __restrict__ u, float4* __restrict__ o, long long nv,
          float a) {
  constexpr long long STEP = (long long)UNROLL * NT * VPT;
  const long long lo = nv * blockIdx.x / gridDim.x;
  const long long hi = nv * (blockIdx.x + 1) / gridDim.x;
  long long j0 = lo;
  for (; j0 + STEP <= hi; j0 += STEP)
    step<HINT, VPT, UNROLL, false>(u, o, j0, hi, a);
  if (j0 < hi) step<HINT, VPT, UNROLL, true>(u, o, j0, hi, a);
}

// ---- the staged copy's ring
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}

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

// An L2 policy that evicts first (the copies read and write each line
// once).
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

template <bool HINT>
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t pol) {
  if constexpr (HINT)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(saddr(dst)),
        "l"(src), "r"(bytes), "r"(saddr(bar)), "l"(pol)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
        "l"(src), "r"(bytes), "r"(saddr(bar))
        : "memory");
}

template <bool HINT>
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes, uint64_t pol) {
  if constexpr (HINT)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
        "[%1], %2, %3;" ::"l"(dst),
        "r"(saddr(src)), "r"(bytes), "l"(pol)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            dst),
        "r"(saddr(src)), "r"(bytes)
        : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

template <int S, int P, int CHUNK, bool ROUNDS, bool HINT = false,
          int MODE = 0>
__global__ void __launch_bounds__(32)
ring_copy(const char* __restrict__ u, char* __restrict__ o, long long units,
          int k) {
  static_assert(P >= 1 && P <= S, "P loads in flight");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S * CHUNK);
  const long long G = gridDim.x, b = blockIdx.x;
  // SPANS: [lo, hi) of the block's own bytes.  ROUNDS: `full` rounds of
  // G chunks, then the block's share [lo, hi) of the last one.
  long long lo, hi, full = 0;
  if (ROUNDS) {
    full = 16 * units / (G * CHUNK);
    const long long rem = units - full * G * (CHUNK / 16);
    lo = 16 * (full * G * (CHUNK / 16) + rem * b / G);
    hi = 16 * (full * G * (CHUNK / 16) + rem * (b + 1) / G);
  } else {
    lo = 16 * (units * b / G);
    hi = 16 * (units * (b + 1) / G);
  }
  const long long per =
      ROUNDS ? full + (hi > lo) : (hi - lo + CHUNK - 1) / CHUNK;
  const long long items = per * k;
  if (threadIdx.x != 0 || items == 0) return;
  for (int s = 0; s < S; ++s) mbar_init(&bar[s]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const uint64_t pol = HINT ? evict_first() : 0;
  auto off = [&](long long i) {
    const long long r = i % per;
    return ROUNDS ? (r < full ? (r * G + b) * CHUNK : lo) : lo + r * CHUNK;
  };
  auto bytes = [&](long long i) {
    if (ROUNDS) return (uint32_t)(i % per < full ? CHUNK : hi - lo);
    const long long left = hi - off(i);
    return (uint32_t)(left < CHUNK ? left : CHUNK);
  };
  auto load = [&](long long j) {
    const int s = (int)(j % S);
    mbar_expect(&bar[s], bytes(j));
    bulk_load<HINT>(smem + s * CHUNK, u + off(j), bytes(j), &bar[s], pol);
  };
  if (MODE == 2) {  // the stores alone, of whatever the buffers hold
    for (long long i = 0; i < items; ++i) {
      bulk_wait_read<S - 1>();
      bulk_store<HINT>(o + off(i), smem + (i % S) * CHUNK, bytes(i), pol);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  for (long long j = 0; MODE != 2 && j + 1 < P && j < items; ++j) load(j);
  for (long long i = 0; MODE != 2 && i < items; ++i) {
    if (i + P - 1 < items) {
      // Item i + P - 1's stage last held item i + P - 1 - S: its store,
      // S - P groups back, has read it.
      bulk_wait_read<S - P>();
      load(i + P - 1);
    }
    const int s = (int)(i % S);
    mbar_wait(&bar[s], (uint32_t)((i / S) & 1));
    if (MODE == 0) {  // MODE 1: the loads alone
      bulk_store<HINT>(o + off(i), smem + s * CHUNK, bytes(i), pol);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int grid_of(const void* kern, int threads, size_t smem, int per_sm,
            int* blocks) {
  int dev = 0, sms = 0, most = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err && smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&most, kern,
                                                             threads, smem);
  if (err) return err;
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * (per_sm < 1 || per_sm > most ? most : per_sm);
  return 0;
}

template <int HINT, int VPT, int UNROLL, bool INPLACE = false>
int tile_launch(const float* u, float* o, long long n, float a,
                void* stream) {
  const long long nv = n / 4, tile = (long long)UNROLL * NT * VPT;
  copy_tile<HINT, VPT, UNROLL, INPLACE>
      <<<(unsigned)((nv + tile - 1) / tile), NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(u), reinterpret_cast<float4*>(o), nv,
      a);
  return (int)cudaGetLastError();
}

template <int HINT, int VPT, int UNROLL>
int span_launch(const float* u, float* o, long long n, float a, int per_sm,
                void* stream) {
  int blocks = 0;
  const int err =
      grid_of((const void*)copy_span<HINT, VPT, UNROLL>, NT, 0, per_sm,
              &blocks);
  if (err) return err;
  copy_span<HINT, VPT, UNROLL><<<blocks, NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(u), reinterpret_cast<float4*>(o), n / 4,
      a);
  return (int)cudaGetLastError();
}

template <int S, int P, int CHUNK, bool ROUNDS, bool HINT = false,
          int MODE = 0>
int ring_launch(const float* u, float* o, long long n, int k, int per_sm,
                void* stream) {
  const size_t smem = (size_t)S * CHUNK + 8 * S;
  int blocks = 0;
  const int err =
      grid_of((const void*)ring_copy<S, P, CHUNK, ROUNDS, HINT, MODE>, 32,
              smem, per_sm, &blocks);
  if (err) return err;
  ring_copy<S, P, CHUNK, ROUNDS, HINT, MODE>
      <<<blocks, 32, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const char*>(u), reinterpret_cast<char*>(o), n / 4, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K18a trials: o = a u over n f32 (n % 4 == 0, 16-byte aligned); per_sm
// the span designs' blocks an SM (0: as many as fit).
int tv_tile(int hint, int vpt, int unroll, const float* u, float* o,
            long long n, float a, void* stream) {
  if (vpt == 2)
    return hint == 0 ? tile_launch<0, 2, 2>(u, o, n, a, stream)
                     : tile_launch<1, 2, 2>(u, o, n, a, stream);
  if (unroll == 8) return tile_launch<1, 1, 8>(u, o, n, a, stream);
  if (unroll == 2) return tile_launch<1, 1, 2>(u, o, n, a, stream);
  return hint == 0   ? tile_launch<0, 1, 4>(u, o, n, a, stream)
         : hint == 1 ? tile_launch<1, 1, 4>(u, o, n, a, stream)
                     : tile_launch<2, 1, 4>(u, o, n, a, stream);
}

// KP2 trials: u <- a u in place.
int tv_tile_inplace(int hint, float* u, long long n, float a, void* stream) {
  return hint == 0 ? tile_launch<0, 1, 4, true>(u, u, n, a, stream)
                   : tile_launch<1, 1, 4, true>(u, u, n, a, stream);
}

int tv_span(int hint, int vpt, int unroll, const float* u, float* o,
            long long n, float a, int per_sm, void* stream) {
  if (vpt == 2)
    return hint == 1 ? span_launch<1, 2, 2>(u, o, n, a, per_sm, stream)
                     : span_launch<0, 2, 2>(u, o, n, a, per_sm, stream);
  if (unroll == 2)
    return hint == 1 ? span_launch<1, 1, 2>(u, o, n, a, per_sm, stream)
                     : span_launch<0, 1, 2>(u, o, n, a, per_sm, stream);
  return hint == 0   ? span_launch<0, 1, 4>(u, o, n, a, per_sm, stream)
         : hint == 1 ? span_launch<1, 1, 4>(u, o, n, a, per_sm, stream)
                     : span_launch<2, 1, 4>(u, o, n, a, per_sm, stream);
}

// KP3 trials: o = u over n f32, k passes; design d (S stages, P loads in
// flight, chunk bytes, dealing).
int tv_ring(int d, const float* u, float* o, long long n, int k, int per_sm,
            void* stream) {
  switch (d) {
    case 0: return ring_launch<4, 3, 16384, false>(u, o, n, k, per_sm, stream);
    case 1: return ring_launch<2, 2, 32768, true>(u, o, n, k, per_sm, stream);
    case 2: return ring_launch<4, 3, 16384, true>(u, o, n, k, per_sm, stream);
    case 3: return ring_launch<4, 4, 16384, true>(u, o, n, k, per_sm, stream);
    case 4: return ring_launch<3, 3, 32768, true>(u, o, n, k, per_sm, stream);
    case 5: return ring_launch<6, 5, 16384, true>(u, o, n, k, per_sm, stream);
    case 6: return ring_launch<4, 3, 32768, true>(u, o, n, k, per_sm, stream);
    case 7: return ring_launch<2, 2, 16384, true>(u, o, n, k, per_sm, stream);
    case 8: return ring_launch<3, 2, 32768, true>(u, o, n, k, per_sm, stream);
    case 9:
      return ring_launch<3, 2, 32768, true, true>(u, o, n, k, per_sm, stream);
    case 10:
      return ring_launch<4, 3, 16384, true, true>(u, o, n, k, per_sm, stream);
    case 11:  // the loads alone (o untouched)
      return ring_launch<3, 2, 32768, true, false, 1>(u, o, n, k, per_sm,
                                                      stream);
    case 12:  // the stores alone (o gets the buffers' contents)
      return ring_launch<3, 2, 32768, true, false, 2>(u, o, n, k, per_sm,
                                                      stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
