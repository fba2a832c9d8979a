// Fused keypoint description: one 40 x 40 patch per keypoint, cut into
// shared memory, its intensity-centroid angle and its 256 rotated-BRIEF
// bits, with nothing but the angle and the bits written to device memory.
//
// Replaces, on the tracking path, the TPU kernel extract_patches_pallas
// (kbslam/ops/pallas_patches.py:114-160) together with the two stages
// that read its patches, ic_angles and bits_from_patches
// (kbslam/frontend/brief.py:157-210). The TPU design materialised the
// [N, 40, 40] patches because its bit tests were one matmul on the MXU
// ([N, 1600] x [1600, 30 * 256], every angle bin, one kept). On Hopper a
// patch is 6.4 KB of shared memory, so each keypoint reads its window
// once, evaluates only its own bin's 256 tests, and writes 260 bytes.
//
// The pyramid may carry a leading stream axis, [S, L, H, W] with S x n
// keypoints: block row blockIdx.y is stream s, which reads its own slab
// stacked + s * L * H * W and its own n origins and outputs, so one
// launch describes every stream (S = 1 is the single pyramid).
//
// For keypoint k with lv = clamp(level[k], 0, L-1),
// y = clamp(y0[k], 0, H-40), x = clamp(x0[k], 0, W-40) (the start clamp
// of jax.lax.dynamic_slice) and p = stacked[lv, y:y+40, x:x+40]:
//
//   m10 = sum dx * p, m01 = sum dy * p over dx^2 + dy^2 <= radius^2,
//         dx = col - 20, dy = row - 20  (brief.py:_ic_moment_vectors)
//   angle[k] = atan2f(m01, m10)
//   bin = rint(remainder(angle, 2pi) / 2pi * 30) mod 30, in float32 in
//         this order with round half to even, as the plain twin computes
//   bits[k, b] = bf16(p[i2]) - bf16(p[i1]) > 0 for the pair (i1, i2) of
//         row b of bin `bin` of the pair table (flat patch offsets, built
//         from the rotated selection matrices; a row whose two rotated
//         points coincide has i1 == i2 and gives 0, as its all-zero
//         selection row does). Each operand is rounded to bfloat16,
//         nearest even, and the two are subtracted in float32 (rounding
//         the difference instead gives other bits): the operand rounding
//         of the twin's product, whose one +1 and one -1 per row make
//         its sum this exact difference.
//
// The moments are summed in another order than the twin's product, so
// angles agree to rounding and a keypoint whose bin fraction sits on a
// .5 boundary may take the neighbouring bin; away from the boundaries
// bins and bits are equal.
//
// What bounds it: bytes. At the tracking step's shapes (3072 keypoints
// on an [8, 480, 640] float32 pyramid) it reads at most the ~3.8 MB of
// pyramid the windows cover plus 37 KB of origins and writes
// 3072 * (4 + 256) B = 0.8 MB: about 1.4 us at 3.35 TB/s (the rows it
// copies are up to 10% wider than the patch, see below). The moments
// are ~4 MFLOP. The stages it replaces wrote 19.7 MB of patches and ran
// a 49.5 GFLOP float32 product, 29 of every 30 columns thrown away. At
// this size the launch itself is expected to dominate. Eight streams in
// one launch (config 4) read and write eight times as much, ~9.8 us.
//
// Design:
// - One warp per keypoint, KEYPOINTS_PER_BLOCK = 4 warps per block: 768
//   blocks of 25.6 KB of shared memory at the tracking shapes, about six
//   per SM on the 132 SMs, all resident in one wave, with 24 windows in
//   flight per SM to cover the load latency. A warp works alone (its own
//   buffer and barrier), so the tail warps of the last block just exit.
// - The window comes in through the TMA unit as 40 bulk row copies
//   (cp.async.bulk, global to shared, completing on one mbarrier per
//   warp): row r copies the 16-byte-aligned superset of its 40 floats,
//   from x & ~3, 40 floats when x is a multiple of 4 and 44 otherwise,
//   into a 44-float pitch; the shift x & 3 is applied when shared memory
//   is read. The pyramid's pitch must be a multiple of 16 bytes (the
//   wrapper checks it), and the superset never passes the row's end,
//   because the row length is a multiple of 4. Lanes issue the copies
//   (rows lane and lane + 32) and the warp waits on the barrier; no
//   register holds the window on its way in. A tensor-map tile load
//   (cp.async.bulk.tensor with a 3-D map and box {40, 40, 1}) would
//   take one instruction instead of 40, but on the H100 this was built
//   for (driver 13.0, runtime 12.9) every tensor-map load stopped with
//   an illegal instruction, for 2-D and 3-D maps and with the
//   documented libcu++ pattern too, while the plain bulk copy runs.
// - Moments: each lane sums 50 pixels of the disc, then a butterfly of
//   warp shuffles (which leaves the same sum in every lane, so every
//   lane computes the same bin).
// - Bits: lane j reads its 8 pairs (32 bytes of the table, two 16-byte
//   loads) and writes bits 8j..8j+7 as one 8-byte store, so a
//   keypoint's 256 bytes go out coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 40;                      // patch side
constexpr int R = 20;                      // patch centre
constexpr int AREA = S * S;                // 1600 patch pixels
constexpr int PITCH = S + 4;               // floats per staged row (176 B)
constexpr int BINS = 30;
constexpr int BITS = 256;
constexpr int KEYPOINTS_PER_BLOCK = 4;     // one warp each
constexpr int THREADS = 32 * KEYPOINTS_PER_BLOCK;
// float32(2 pi): the value the twin's Python scalar becomes
constexpr float TWO_PI = 6.28318530717958647692f;

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// flat patch offset r * 40 + c -> its place r * PITCH + c in the window
__device__ __forceinline__ int staged(int i) {
    return i + (i / S) * (PITCH - S);
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__global__ void __launch_bounds__(THREADS)
describe_kernel(const float* __restrict__ stacked,
                const int* __restrict__ level,
                const int* __restrict__ y0,
                const int* __restrict__ x0,
                const short* __restrict__ pairs,   // [30, 256, 2] (i1, i2)
                float* __restrict__ angle_out,     // [n]
                uint8_t* __restrict__ bits_out,    // [n, 256]
                int n, int L, int H, int W, int radius) {
    __shared__ __align__(128) float window[KEYPOINTS_PER_BLOCK][S * PITCH];
    __shared__ __align__(8) uint64_t full[KEYPOINTS_PER_BLOCK];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int k = blockIdx.x * KEYPOINTS_PER_BLOCK + warp;
    if (k >= n) return;      // no block-wide barrier follows

    // this block's stream: its pyramid slab, origins and outputs
    const size_t s = blockIdx.y;
    stacked += s * L * H * W;
    level += s * n;
    y0 += s * n;
    x0 += s * n;
    angle_out += s * n;
    bits_out += s * n * BITS;

    const int lv = min(max(level[k], 0), L - 1);
    const int y = min(max(y0[k], 0), H - S);
    const int x = min(max(x0[k], 0), W - S);
    const int shift = x & 3;
    const uint32_t row_bytes = shift ? PITCH * 4 : S * 4;
    const float* src = stacked + (static_cast<size_t>(lv) * H + y) * W
                       + (x - shift);
    float* buf = window[warp];
    const float* p = buf + shift;    // p[r * PITCH + c] = patch pixel (r, c)
    const uint32_t bar = static_cast<uint32_t>(
        __cvta_generic_to_shared(&full[warp]));

    if (lane == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(bar) : "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(S * row_bytes) : "memory");
    }
    __syncwarp();
    for (int r = lane; r < S; r += 32) {
        const uint32_t dst = static_cast<uint32_t>(
            __cvta_generic_to_shared(buf + r * PITCH));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            :: "r"(dst), "l"(src + static_cast<size_t>(r) * W),
               "r"(row_bytes), "r"(bar)
            : "memory");
    }
    wait_parity(bar, 0);

    // intensity-centroid moments over the disc
    const int rr = radius * radius;
    float m10 = 0.f, m01 = 0.f;
    for (int i = lane; i < AREA; i += 32) {
        const int row = i / S;
        const int dy = row - R;
        const int dx = i - row * S - R;
        if (dx * dx + dy * dy <= rr) {
            const float v = p[row * PITCH + dx + R];
            m10 += static_cast<float>(dx) * v;
            m01 += static_cast<float>(dy) * v;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        m10 += __shfl_xor_sync(0xffffffffu, m10, off);
        m01 += __shfl_xor_sync(0xffffffffu, m01, off);
    }
    const float theta = atan2f(m01, m10);

    // the angle's bin, in the twin's float32 operations and order
    float md = fmodf(theta, TWO_PI);      // torch.remainder takes
    if (md < 0.f) md += TWO_PI;           // the divisor's sign
    const float frac = md / TWO_PI * static_cast<float>(BINS);
    int bin = static_cast<int>(rintf(frac)) % BINS;
    if (bin < 0 || bin >= BINS) bin = 0;           // NaN input: stay in the table

    // this lane's 8 tests: 8 (i1, i2) pairs = 32 bytes of the table
    union {
        int4 v[2];
        short s[16];
    } pr;
    const int4* row = reinterpret_cast<const int4*>(
        pairs + (static_cast<size_t>(bin) * BITS + lane * 8) * 2);
    pr.v[0] = __ldg(row);
    pr.v[1] = __ldg(row + 1);
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float a = bf16_round(p[staged(pr.s[2 * j])]);
        const float b = bf16_round(p[staged(pr.s[2 * j + 1])]);
        word |= static_cast<uint64_t>(b - a > 0.f) << (8 * j);
    }
    reinterpret_cast<uint64_t*>(bits_out + static_cast<size_t>(k) * BITS)[lane]
        = word;
    if (lane == 0) angle_out[k] = theta;
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t); returns cudaGetLastError().
// `streams` pyramids of [L, H, W] one after another, n keypoints each.
// Shapes, pointers, the 16-byte alignment of `stacked` and its row pitch
// (which keeps every stream's slab aligned too) are validated by the
// Python wrapper (kbslam_torch/ops/describe.py).
int kbslam_describe_keypoints(const float* stacked, const int* level,
                              const int* y0, const int* x0,
                              const short* pairs, float* angle,
                              unsigned char* bits, int streams, int n, int L,
                              int H, int W, int radius, void* stream) {
    if (n > 0 && streams > 0) {
        const dim3 blocks((n + KEYPOINTS_PER_BLOCK - 1) / KEYPOINTS_PER_BLOCK,
                          streams);
        describe_kernel<<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
            stacked, level, y0, x0, pairs, angle,
            reinterpret_cast<uint8_t*>(bits), n, L, H, W, radius);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
