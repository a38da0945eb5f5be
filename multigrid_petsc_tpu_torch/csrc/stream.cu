// K18a: the blocked copy o = a * u over a 2-D array (f32, f64, bf16), for
// Hopper (sm_90a), bound through a plain C interface (ctypes).
//
// Replaces the kernel of benchmarks/baseline_configs.py
// measured_pallas_bandwidth (its pallas_call: o = u * 1.0001 in (256, n)
// tiles): the stream rate a hand-written kernel reaches on the card, the
// yardstick the kernels' byte bounds are read against.  It is on no solve's
// path.
//
// What bounds it on the H100: bytes, one read and one write of each entry
// against one multiply.  So each load moves 16 bytes a thread (float4,
// double2, eight bf16 values), neighbouring threads on neighbouring
// addresses, where both pointers are 16-byte aligned (a tensor's own
// storage always is): a block streams tiles of UNROLL x 256 vectors, each
// thread issuing its UNROLL loads before its stores, one block a tile (a
// grid-stride loop over the tiles where they outnumber MAX_BLOCKS).  The
// vector loads and stores carry the evict-first hint (__ldcs, __stcs):
// each line is touched once, and the hint kept this kernel level with
// torch.mul(out=) and x.mul_ on the device (0.5-1.6% faster than plain
// loads and stores; scripts/time_copies.py --variants).  Measured slower
// there and not kept: whole waves of persistent blocks each walking a
// contiguous span (13%: the active lines spread over the whole array),
// 32 bytes a thread a step (20%), tiles of 2 or 8 vectors a thread (the
// same).  An unaligned pointer, and the last few entries, go one entry a
// step.  The scalar comes in the compute type, already rounded to the
// storage type by the wrapper (as the TPU kernel casts 1.0001 to its
// dtype); a bf16 product is formed in f32 (exact: both factors hold 8
// significant bits) and rounded once to bf16.
//
// KP2, the same copy in place, u <- a * u (mg_scale_copy_inplace*):
// replaces the aliased copies of benchmarks/probe_dma.py probe_b and
// benchmarks/probe_cg_ablate.py _copy_chain (input_output_aliases {0: 0}),
// the copy chains that tell fresh outputs from in-place ones.  It is the
// kernel above with the output as its input (INPLACE): each entry is read
// and written by one thread, so no other thread can see it half done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int UNROLL = 4;
constexpr long long MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ float4 scale16(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

__device__ __forceinline__ double2 scale16(double2 x, double a) {
  return make_double2(x.x * a, x.y * a);
}

__device__ __forceinline__ uint4 scale16(uint4 x, float a) {
  unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&w[j]);
    const float2 f = __bfloat1622float2(p);
    p = __floats2bfloat162_rn(f.x * a, f.y * a);
    w[j] = *reinterpret_cast<unsigned*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float scale1(float x, float a) { return x * a; }
__device__ __forceinline__ double scale1(double x, double a) { return x * a; }
__device__ __forceinline__ __nv_bfloat16 scale1(__nv_bfloat16 x, float a) {
  return __float2bfloat16_rn(__bfloat162float(x) * a);
}

// V: the 16-byte vector of T (float4, double2, uint4 for bf16); C: the
// compute type.  INPLACE: o <- a * o (u is not read; one pointer may not
// be passed as both u and o, which the restrict qualifiers forbid).
template <class T, class V, class C, bool INPLACE>
__global__ void __launch_bounds__(NTHREADS)
scale_copy_kernel(const T* __restrict__ u_in, T* __restrict__ o, long long n,
                  C a, int vec) {
  const T* u = INPLACE ? o : u_in;
  long long done = 0;
  if (vec) {
    constexpr int W = sizeof(V) / sizeof(T);
    constexpr long long TILE = (long long)UNROLL * NTHREADS;
    const long long nv = n / W;
    const V* uv = reinterpret_cast<const V*>(u);
    V* ov = reinterpret_cast<V*>(o);
    for (long long t = blockIdx.x; t * TILE < nv; t += gridDim.x) {
      const long long j0 = t * TILE + threadIdx.x;
      V x[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long j = j0 + (long long)k * NTHREADS;
        if (j < nv) x[k] = __ldcs(uv + j);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long j = j0 + (long long)k * NTHREADS;
        if (j < nv) __stcs(ov + j, scale16(x[k], a));
      }
    }
    done = nv * W;
  }
  const long long stride = (long long)gridDim.x * NTHREADS;
  for (long long j = done + (long long)blockIdx.x * NTHREADS + threadIdx.x;
       j < n; j += stride)
    o[j] = scale1(u[j], a);
}

template <class T, class V, class C, bool INPLACE = false>
int launch(const T* u, T* o, long long n, C a, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int vec =
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(o)) &
       15) == 0;
  const long long per =
      vec ? (long long)(sizeof(V) / sizeof(T)) * UNROLL : 1;
  const long long want = (n + per * NTHREADS - 1) / (per * NTHREADS);
  const unsigned blocks =
      (unsigned)(want < 1 ? 1 : want < MAX_BLOCKS ? want : MAX_BLOCKS);
  scale_copy_kernel<T, V, C, INPLACE>
      <<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(INPLACE ? nullptr : u,
                                                      o, n, a, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o = a * u over n contiguous entries; a already rounded to the storage
// type and given in the compute type.
int mg_scale_copy(const float* u, float* o, long long n, double a,
                  void* stream) {
  return launch<float, float4, float>(u, o, n, (float)a, stream);
}

int mg_scale_copy_f64(const double* u, double* o, long long n, double a,
                      void* stream) {
  return launch<double, double2, double>(u, o, n, a, stream);
}

int mg_scale_copy_bf16(const __nv_bfloat16* u, __nv_bfloat16* o, long long n,
                       double a, void* stream) {
  return launch<__nv_bfloat16, uint4, float>(u, o, n, (float)a, stream);
}

// u <- a * u in place over n contiguous entries (KP2).
int mg_scale_copy_inplace(float* u, long long n, double a, void* stream) {
  return launch<float, float4, float, true>(u, u, n, (float)a, stream);
}

int mg_scale_copy_inplace_f64(double* u, long long n, double a,
                              void* stream) {
  return launch<double, double2, double, true>(u, u, n, a, stream);
}

int mg_scale_copy_inplace_bf16(__nv_bfloat16* u, long long n, double a,
                               void* stream) {
  return launch<__nv_bfloat16, uint4, float, true>(u, u, n, (float)a,
                                                   stream);
}

}  // extern "C"
