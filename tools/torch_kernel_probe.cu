// Probe kernels for tools/torch_kernel_probe.py (sm_90a, plain C entry
// points): does a tensor-map TMA load run on this card, does a 1D bulk
// copy, how fast is B9's window fetch when each row is read as five
// aligned 4-byte words instead of its two aligned 16-byte chunks, and
// B7's earlier design (a block of 192 threads an MB, one byte a thread
// at a time) as the yardstick of its warp-an-MB redesign.

#include <cuda.h>
#include <cuda/barrier>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cde = cuda::device::experimental;
using barrier = cuda::barrier<cuda::thread_scope_block>;

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ void wait_phase0(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(0) : "memory");
  }
}

// one CTA a window: a 16 x 16 x 4 box through libcu++'s TMA load
__global__ void tma_libcu(const __grid_constant__ CUtensorMap map,
                          const int* xy, uint8_t* out) {
  __shared__ alignas(128) uint8_t buf[1024];
#pragma nv_diag_suppress static_var_with_dynamic_init
  __shared__ barrier bar;
  if (threadIdx.x == 0) {
    init(&bar, blockDim.x);
    cde::fence_proxy_async_shared_cta();
  }
  __syncthreads();
  barrier::arrival_token token;
  if (threadIdx.x == 0) {
    cde::cp_async_bulk_tensor_3d_global_to_shared(
        buf, &map, xy[2 * blockIdx.x], xy[2 * blockIdx.x + 1], 0, bar);
    token = cuda::device::barrier_arrive_tx(bar, 1, sizeof(buf));
  } else {
    token = bar.arrive();
  }
  bar.wait(std::move(token));
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    out[blockIdx.x * 1024 + i] = buf[i];
}

// the same box through inline PTX, the map at a global-memory address
__global__ void tma_ptx(const CUtensorMap* map, const int* xy,
                        uint8_t* out) {
  __shared__ __align__(128) uint8_t buf[1024];
  __shared__ __align__(8) unsigned long long full;
  const unsigned bar = smem_addr(&full);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile("fence.proxy.async.shared::cta;");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(1024) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
        ::"r"(smem_addr(buf)), "l"(map), "r"(xy[2 * blockIdx.x]),
        "r"(xy[2 * blockIdx.x + 1]), "r"(0), "r"(bar) : "memory");
    wait_phase0(bar);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    out[blockIdx.x * 1024 + i] = buf[i];
}

// a 1D bulk copy (no tensor map): the 16-aligned 16 bytes of each row
// of plane 0 that hold the window's start
__global__ void bulk_1d(const uint8_t* planes, int wp, const int* xy,
                        uint8_t* out) {
  __shared__ __align__(128) uint8_t buf[256];
  __shared__ __align__(8) unsigned long long full;
  const unsigned bar = smem_addr(&full);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile("fence.proxy.async.shared::cta;");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(256) : "memory");
    const int x = xy[2 * blockIdx.x] & ~15, y = xy[2 * blockIdx.x + 1];
    for (int r = 0; r < 16; ++r) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], 16, [%2];"
          ::"r"(smem_addr(buf + 16 * r)),
          "l"(planes + static_cast<size_t>(y + r) * wp + x), "r"(bar)
          : "memory");
    }
    wait_phase0(bar);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    out[blockIdx.x * 1024 + i] = buf[i];
}

// B9's window fetch with each row read as five aligned 4-byte words
// (csrc/windows8.cu reads its two aligned 16-byte chunks)
__global__ void windows8_words(const uint8_t* __restrict__ planes, int hp,
                               int wp, const int* __restrict__ mv, int n8,
                               int nbw, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (b >= n8) return;
  const int lane = threadIdx.x & 31;
  const int by = b / nbw;
  const int bx = b - by * nbw;
  const int ys = 8 * by + 20 + mv[2 * b + 1];
  const int xs = 8 * bx + 20 + mv[2 * b];
  if (ys < 0 || xs < 0 || ys + 16 > hp || xs + 16 > wp) __trap();
  const int sh = 8 * (xs & 3);
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * 1024);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pr = lane + 32 * h;
    const unsigned* src = reinterpret_cast<const unsigned*>(
        planes + (pr >> 4) * static_cast<size_t>(hp) * wp +
        static_cast<size_t>(ys + (pr & 15)) * wp + (xs & ~3));
    const unsigned w0 = __ldg(src), w1 = __ldg(src + 1),
                   w2 = __ldg(src + 2), w3 = __ldg(src + 3);
    const unsigned w4 = sh ? __ldg(src + 4) : 0u;
    dst[pr] = make_uint4(__funnelshift_r(w0, w1, sh),
                         __funnelshift_r(w1, w2, sh),
                         __funnelshift_r(w2, w3, sh),
                         __funnelshift_r(w3, w4, sh));
  }
}

int encode(CUtensorMap* map, const void* planes, int hp, int wp) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                              cudaEnableDefault, &q) != cudaSuccess ||
      fn == nullptr) {
    return -1;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(wp),
                              static_cast<cuuint64_t>(hp), 4};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(wp),
                                 static_cast<cuuint64_t>(hp) * wp};
  const cuuint32_t box[3] = {16, 16, 4};
  const cuuint32_t estr[3] = {1, 1, 1};
  return static_cast<int>(reinterpret_cast<EncodeTiled>(fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(planes), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace

// mode 0: tma_libcu, 1: tma_ptx (map_dev: 128 bytes of device memory),
// 2: bulk_1d. Returns 0, the CUresult of a failed encode + 100000, or
// the launch's CUDA error.
extern "C" int probe_copy(int mode, const void* planes, int hp, int wp,
                          const void* xy, int n, void* out, void* map_dev) {
  if (mode == 2) {
    bulk_1d<<<n, 32>>>(static_cast<const uint8_t*>(planes), wp,
                       static_cast<const int*>(xy),
                       static_cast<uint8_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap map;
  const int r = encode(&map, planes, hp, wp);
  if (r != 0) return 100000 + r;
  if (mode == 0) {
    tma_libcu<<<n, 32>>>(map, static_cast<const int*>(xy),
                         static_cast<uint8_t*>(out));
  } else {
    cudaMemcpy(map_dev, &map, sizeof(map), cudaMemcpyHostToDevice);
    tma_ptx<<<n, 32>>>(static_cast<const CUtensorMap*>(map_dev),
                       static_cast<const int*>(xy),
                       static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_windows8_words(const void* planes, int hp, int wp,
                                    const void* mv, int mbh, int mbw,
                                    void* out, void* stream) {
  const int n8 = 4 * mbh * mbw;
  windows8_words<<<(n8 + 7) / 8, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hp, wp,
      static_cast<const int*>(mv), n8, 2 * mbw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B7 as csrc/windows.cu had it before its redesign: one block per MB, each
// thread copies bytes t, t + 192, ... of the 4 x 24 x 24 window.
__global__ void windows_bytes(const uint8_t* __restrict__ planes, int hp,
                              int wp, const int* __restrict__ mv, int mbw,
                              uint8_t* __restrict__ out) {
  const int n = blockIdx.x;
  const int my = n / mbw;
  const int mx = n - my * mbw;
  const int ys = 16 * my + 20 + mv[2 * n + 1];
  const int xs = 16 * mx + 20 + mv[2 * n];
  if (ys < 0 || xs < 0 || ys + 24 > hp || xs + 24 > wp) __trap();
  const size_t plane = static_cast<size_t>(hp) * wp;
  uint8_t* dst = out + static_cast<size_t>(n) * 4 * 24 * 24;
  for (int t = threadIdx.x; t < 4 * 24 * 24; t += blockDim.x) {
    const int p = t / (24 * 24);
    const int rc = t - p * 24 * 24;
    const int r = rc / 24;
    const int c = rc - r * 24;
    dst[t] = planes[p * plane + static_cast<size_t>(ys + r) * wp + xs + c];
  }
}

extern "C" int probe_windows_bytes(const void* planes, int hp, int wp,
                                   const void* mv, int mbh, int mbw,
                                   void* out, void* stream) {
  windows_bytes<<<mbh * mbw, 192, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hp, wp,
      static_cast<const int*>(mv), mbw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
