// int8 GEMM with a dequantisation epilogue for Hopper (sm_90a): the wgmma
// instance.
//
// Replaces the TPU kernel mimrl_tpu/ops/pallas/int8_matmul.py::int8_matmul
// (kernel _matmul_kernel), as int8_matmul.cu does, for every shape whose K
// is a multiple of 16 and whose operand bases are 16-byte aligned (what TMA
// needs); ops/int8_matmul.py::plan chooses between the two sources:
//
//     out[m, n] = round_to(Out)((float(sum_k a[m, k] * bt[n, k]) * sa[m]) * sb[n])
//
// a: [M, K] int8 row-major, bt: [N, K] int8 row-major (both K-major, the
// only layout wgmma takes for 8-bit operands). sa: [M], sb: [N] float32.
// out: [M, N] row-major, float32 or bfloat16. The products are summed in
// int32 (exact; the pieces of a split K are summed in int32 too) and the
// epilogue is (float(acc) * sa[m]) * sb[n] in float32 with one rounding,
// so the result equals the plain version bit for bit, and is the same from
// run to run.
//
// Bound on the H100 (3.35 TB/s, 1979 TOP/s int8): the forward shapes of the
// canonical path, [12800, 768 | 3072] x [768 | 3072, 768..3072] -> bf16,
// sit near the ridge ([12800, 768] x [768, 3072]: 30.5 us of operations,
// 27.1 us of bytes, most of them the 78.6 MB bf16 output); the
// weight-gradient shapes (K = 12800, M x N = 768..3072 x 768..3072, float32
// out) are bound by operations.
//
// Design.
// - Tiles of 128 x 256 outputs by 128 bytes of K. A stage of the ring is
//   16 KB of a and 32 KB of bt; three stages, 144 KB. The tiles arrive by
//   TMA (cp.async.bulk.tensor, 128-byte swizzle, zero fill past M, N and K)
//   and each stage has a "full" mbarrier (the TMA's bytes) and an "empty"
//   one (every consumer thread arrives when its products have read it).
// - Warp specialisation, 384 threads: warpgroup 0 is the producer (one
//   thread starts the loads; setmaxnreg down to 40), warpgroups 1 and 2 are
//   the consumers (setmaxnreg up to 232), each owning 64 rows of the tile:
//   four wgmma.m64n256k32.s32.s8.s8 per stage, both operands read from
//   shared memory through descriptors, 128 int32 accumulators a thread. A
//   stage is released one step late (wgmma.wait_group 1), so one group of
//   products is always in flight.
// - Persistent grid of at most one block per SM, each walking the list of
//   segments (tile, range of K blocks) that the wrapper's schedule gives
//   it (ops/int8_matmul.py::schedule). The producer runs ahead across
//   segments, so a tile's epilogue overlaps the next tile's loads. Where
//   there are at least as many tiles as SMs (the forward shapes), block b
//   takes tiles b, b + grid, ..., whole. Where there are fewer (the
//   weight-gradient shapes: 18-72 tiles, K = 12800), the tiles' K blocks
//   are dealt out in equal runs (stream-K), so a tile may be cut into
//   pieces on several blocks: each piece stores its int32 partial tile in
//   a workspace slot, and a second kernel, int8_matmul_wgmma_reduce, sums
//   a tile's pieces in int32 and applies the epilogue. Integer sums are
//   exact in any order, so the result does not depend on the schedule.
// - Epilogue: each consumer warpgroup stages its 64 rows of the tile in
//   shared memory (32 KB: all 256 columns in bf16, half of them at a time
//   in float32) as 128-byte column chunks, 16-byte pieces swizzled by row
//   as TMA's 128-byte swizzle lays them out (no bank conflicts), and one
//   thread hands them to TMA stores, which clip rows and columns past the
//   tensor. The warpgroup goes on to the next tile at once: the stores
//   write back while its products run, and the staging is reused only
//   once they have read it. The forward shapes write up to 78.6 MB of
//   bf16, as long on the card's memory as their products take on the
//   tensor cores, so the overlap is what lets them near the bound. Where
//   a row's bytes are not 16-byte aligned (N * sizeof(Out) % 16 != 0, which
//   TMA cannot address), the threads write the staged chunks back element
//   by element.
//
// Launch rules: both kernels run on the caller's stream, allocate nothing
// (the wrapper passes the schedule and the workspace) and do not
// synchronise. The TMA descriptors are encoded on the host by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda. The C entry point returns a cudaError_t value (0 = ok).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows per tile (64 per consumer warpgroup)
constexpr int kBN = 256;  // output columns per tile
constexpr int kBK = 128;  // K bytes per stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kThreads = 384;
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = kBN * kBK;
constexpr int kStageBytes = kABytes + kBBytes;
// per consumer warpgroup: its 64 output rows of a tile in bf16 (half of
// them in float32), as 128-byte column chunks of 8 KB
constexpr int kStagingBytes = 64 * 256 * 2;
constexpr int kChunkBytes = 64 * 128;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStagingBytes +
                           2 * kStages * 8 + 1024;  // + alignment
constexpr int kTileElems = kBM * kBN;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// a [rows, K] box of 128 bytes x rows at (k, row) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// a box of 64 rows x 128 bytes from shared memory (in the 128-byte swizzle)
// to out at (col, row); rows and columns past the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the stores started so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes, visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle that TMA wrote:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the leading
// offset is unused for this layout
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 256] (+)= a[64 x 32] . b[256 x 32]^T, int8 in, int32 accumulators
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "
      "%94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// two neighbouring outputs of a row as they are staged: 4 or 8 bytes
__device__ __forceinline__ void stage_pair(int8_t* p, float x, float y,
                                           float*) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void stage_pair(int8_t* p, float x, float y,
                                           __nv_bfloat16*) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The accumulator layout of wgmma m64nN (each warp w of the warpgroup owns
// rows 16w..16w+15): d[4j + h] sits at row 16w + lane / 4 + 8 * (h / 2),
// column 8j + 2 * (lane % 4) + h % 2.
//
// sched: grid + 1 offsets, then 4 ints per segment (tile, first K block,
// end K block, partial slot or -1); block b runs segments sched[b] ..
// sched[b + 1] - 1 in order. A segment with slot -1 is a whole tile and
// ends in the epilogue; any other leaves its int32 partial tile in
// ws[slot] for int8_matmul_wgmma_reduce.
template <typename Out>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ CUtensorMap map_out,
                         const float* __restrict__ sa,
                         const float* __restrict__ sb, Out* __restrict__ out,
                         int* __restrict__ ws, const int* __restrict__ sched,
                         int m_len, int n_len, int tiles_n, int tma_out) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  int8_t* smem = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  int8_t* staging = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * kStagingBytes);
  uint64_t* empty = full + kStages;
  const int seg_begin = sched[blockIdx.x], seg_end = sched[blockIdx.x + 1];
  const int* segs = sched + gridDim.x + 1;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, across segments
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int sg = seg_begin; sg < seg_end; ++sg) {
      const int tile = segs[4 * sg];
      const int row_a = (tile / tiles_n) * kBM, row_b = (tile % tiles_n) * kBN;
      for (int kb = segs[4 * sg + 1]; kb < segs[4 * sg + 2]; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        int8_t* st = smem + stage * kStageBytes;
        mbar_expect_tx(&full[stage], kStageBytes);
        tma_load(st, &map_a, kb * kBK, row_a, &full[stage]);
        tma_load(st + kABytes, &map_b, kb * kBK, row_b, &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;  // within the warpgroup
  const int warp = t >> 5, lane = t & 31;
  const int r_local = cw * 64 + warp * 16 + (lane >> 2);  // and + 8
  const int c_lane = 2 * (lane & 3);
  int8_t* stg = staging + cw * kStagingBytes;
  int stage = 0;
  uint32_t phase = 0;
  int acc[128];

  for (int sg = seg_begin; sg < seg_end; ++sg) {
    const int tile = segs[4 * sg], slot = segs[4 * sg + 3];
    const int kb0 = segs[4 * sg + 1], kb1 = segs[4 * sg + 2];
    const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;

    int prev = -1;
    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(&full[stage], phase);
      const int8_t* st = smem + stage * kStageBytes;
      const uint64_t da = smem_desc(st + cw * 64 * kBK);
      const uint64_t db = smem_desc(st + kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes = 2 descriptor units
        wgmma_s8(acc, da + 2 * kk, db + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (prev >= 0) mbar_arrive(&empty[prev]);

    if (slot >= 0) {
      // a partial tile, in tile-local coordinates (no edges to mask)
      int* mine = ws + (size_t)slot * kTileElems;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + c_lane;
        __stcg(reinterpret_cast<int2*>(mine + r_local * kBN + col),
               make_int2(acc[4 * j], acc[4 * j + 1]));
        __stcg(reinterpret_cast<int2*>(mine + (r_local + 8) * kBN + col),
               make_int2(acc[4 * j + 2], acc[4 * j + 3]));
      }
      continue;
    }

    // epilogue: (float(acc) * sa[m]) * sb[n], one rounding, staged in
    // shared memory by 128-byte column chunks (16-byte pieces swizzled by
    // row, as TMA's 128-byte swizzle lays them out)
    constexpr int kOut = (int)sizeof(Out);
    constexpr int kChunkCols = 128 / kOut;     // 64 bf16 or 32 float32
    constexpr int kPerChunk = kChunkCols / 8;  // n8 groups per chunk
    constexpr int kPieceCols = 16 / kOut;
    constexpr int kChunks = kBN / kChunkCols;  // 4 bf16 or 8 float32
    constexpr int kPart = kStagingBytes / kChunkBytes;  // chunks staged at once
    const int row0 = m0 + r_local, row1 = row0 + 8;
    const float s0 = row0 < m_len ? sa[row0] : 0.f;
    const float s1 = row1 < m_len ? sa[row1] : 0.f;
    const int sr0 = r_local - cw * 64, sr1 = sr0 + 8;  // staging rows
    if (tma_out) {
      // TMA stores write the tile back while the next one is computed; the
      // staging is reused only once they have read it
      if (t == 0) bulk_wait_read();
      named_sync(2 + cw, 128);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int cc = c % kPart;
      int8_t* chunk = stg + (tma_out ? cc * kChunkBytes : 0);
#pragma unroll
      for (int jj = 0; jj < kPerChunk; ++jj) {
        const int j = c * kPerChunk + jj;
        const int col = n0 + 8 * j + c_lane;
        const float b0 = col < n_len ? sb[col] : 0.f;
        const float b1 = col + 1 < n_len ? sb[col + 1] : 0.f;
        const int byte = (8 * jj + c_lane) * kOut;
        const int piece = byte >> 4, within = byte & 15;
        stage_pair(chunk + sr0 * 128 + ((piece ^ (sr0 & 7)) << 4) + within,
                   __fmul_rn(__fmul_rn((float)acc[4 * j], s0), b0),
                   __fmul_rn(__fmul_rn((float)acc[4 * j + 1], s0), b1),
                   (Out*)nullptr);
        stage_pair(chunk + sr1 * 128 + ((piece ^ (sr1 & 7)) << 4) + within,
                   __fmul_rn(__fmul_rn((float)acc[4 * j + 2], s1), b0),
                   __fmul_rn(__fmul_rn((float)acc[4 * j + 3], s1), b1),
                   (Out*)nullptr);
      }
      if (tma_out) {
        if (cc == kPart - 1 || c == kChunks - 1) {
          fence_proxy_async();
          named_sync(2 + cw, 128);
          if (t == 0) {
#pragma unroll
            for (int q = 0; q <= cc; ++q)
              tma_store(&map_out, stg + q * kChunkBytes,
                        n0 + (c - cc + q) * kChunkCols, m0 + cw * 64);
            bulk_commit();
          }
          if (c != kChunks - 1) {  // the next part reuses the staging
            if (t == 0) bulk_wait_read();
            named_sync(2 + cw, 128);
          }
        }
        continue;
      }
      // rows whose bytes are not 16-byte aligned (N * sizeof(Out) % 16 !=
      // 0): written back by the threads, element by element
      named_sync(2 + cw, 128);
#pragma unroll
      for (int p = t; p < 64 * 8; p += 128) {
        const int r = p >> 3, q = p & 7;
        const int grow = m0 + cw * 64 + r;
        const int gcol = n0 + c * kChunkCols + q * kPieceCols;
        const Out* v = reinterpret_cast<const Out*>(
            stg + r * 128 + ((q ^ (r & 7)) << 4));
        if (grow < m_len) {
          Out* dst = out + (size_t)grow * n_len + gcol;
          for (int e = 0; e < kPieceCols && gcol + e < n_len; ++e)
            dst[e] = v[e];
        }
      }
      named_sync(2 + cw, 128);
    }
  }
  if (t == 0) bulk_wait();  // the last stores are done before the exit
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4],
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < 4; ++e) store1(p + e, v[e]);
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4],
                                       bool vec) {
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  } else {
    for (int e = 0; e < 4; ++e) store1(p + e, v[e]);
  }
}

// The split tiles: fix holds 3 ints per tile (tile, first slot, slots);
// block (f, y) sums rows 16 y .. 16 y + 15 of tile f's partials in int32
// and applies the epilogue. 256 threads, four neighbouring columns each.
template <typename Out>
__global__ void __launch_bounds__(256)
int8_matmul_wgmma_reduce(const int* __restrict__ ws,
                         const int* __restrict__ fix,
                         const float* __restrict__ sa,
                         const float* __restrict__ sb, Out* __restrict__ out,
                         int m_len, int n_len, int tiles_n) {
  const int tile = fix[3 * blockIdx.x], slot0 = fix[3 * blockIdx.x + 1];
  const int slots = fix[3 * blockIdx.x + 2];
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const bool vec = n_len % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = (i * 256 + threadIdx.x) * 4;  // of 16 x 256
    const int r = blockIdx.y * 16 + e / kBN, c = e % kBN;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int s = 0; s < slots; ++s) {
      const int4 x = __ldcg(reinterpret_cast<const int4*>(
          ws + (size_t)(slot0 + s) * kTileElems + r * kBN + c));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int row = m0 + r, col = n0 + c;
    if (row >= m_len || col >= n_len) continue;
    const float s_row = sa[row];
    const int acc[4] = {sum.x, sum.y, sum.z, sum.w};
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = col + q < n_len
                 ? __fmul_rn(__fmul_rn((float)acc[q], s_row), sb[col + q])
                 : 0.f;
    Out* dst = out + (size_t)row * n_len + col;
    if (col + 4 <= n_len) {
      store4(dst, v, vec);
    } else {
      for (int q = 0; col + q < n_len; ++q) store1(dst + q, v[q]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major int8 [rows, k_len] matrix read in boxes of 128 bytes x box_rows
bool encode(CUtensorMap* map, const void* base, int rows, int k_len,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k_len, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k_len};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out [m_len, n_len] written in boxes of 64 rows x 128 bytes
bool encode_out_map(CUtensorMap* map, void* base, int m_len, int n_len,
                    CUtensorMapDataType type, int elem_bytes) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n_len, (cuuint64_t)m_len};
  const cuuint64_t strides[1] = {(cuuint64_t)n_len * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, base, dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
bool encode_out(CUtensorMap* map, void* base, int m_len, int n_len, float*) {
  return encode_out_map(map, base, m_len, n_len,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
}
bool encode_out(CUtensorMap* map, void* base, int m_len, int n_len,
                __nv_bfloat16*) {
  return encode_out_map(map, base, m_len, n_len,
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2);
}

template <typename Out>
int launch(const void* a, const void* bt, const void* sa, const void* sb,
           void* out, void* ws, const void* sched, const void* fix,
           int m_len, int n_len, int k_len, int grid, int n_fix,
           cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_out = {};
  if (!encode(&map_a, a, m_len, k_len, kBM) ||
      !encode(&map_b, bt, n_len, k_len, kBN))
    return (int)cudaErrorInvalidValue;
  // TMA stores need 16-byte aligned rows
  const int tma_out = (size_t)n_len * sizeof(Out) % 16 == 0 &&
                      (uintptr_t)out % 16 == 0;
  if (tma_out && !encode_out(&map_out, out, m_len, n_len, (Out*)nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (n_len + kBN - 1) / kBN;
  auto kern = int8_matmul_wgmma_kernel<Out>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_b, map_out, static_cast<const float*>(sa),
      static_cast<const float*>(sb), static_cast<Out*>(out),
      static_cast<int*>(ws), static_cast<const int*>(sched), m_len, n_len,
      tiles_n, tma_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_fix == 0) return (int)err;
  int8_matmul_wgmma_reduce<Out><<<dim3(n_fix, kBM / 16), 256, 0, stream>>>(
      static_cast<const int*>(ws), static_cast<const int*>(fix),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<Out*>(out), m_len, n_len, tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

// a: [M, K], bt: [N, K] int8, both 16-byte aligned with K % 16 == 0; sa [M],
// sb [N] float32; out [M, N]. sched: the segments of the grid's blocks (see
// int8_matmul_wgmma_kernel), fix: n_fix split tiles (see
// int8_matmul_wgmma_reduce), ws: their int32 partial tiles of 128 x 256
// (none where n_fix is 0), all on the device. out_dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_int8_matmul_wgmma(const void* a, const void* bt,
                                       const void* sa, const void* sb,
                                       void* out, void* ws, const void* sched,
                                       const void* fix, int m_len, int n_len,
                                       int k_len, int out_dtype, int grid,
                                       int n_fix, void* stream) {
  if (m_len <= 0 || n_len <= 0 || k_len <= 0 || k_len % 16 != 0 ||
      grid < 1 || n_fix < 0 || (uintptr_t)a % 16 != 0 ||
      (uintptr_t)bt % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch<float>(a, bt, sa, sb, out, ws, sched, fix, m_len, n_len,
                         k_len, grid, n_fix, s);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(a, bt, sa, sb, out, ws, sched, fix, m_len,
                                 n_len, k_len, grid, n_fix, s);
  return (int)cudaErrorInvalidValue;
}
