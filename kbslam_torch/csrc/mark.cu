// Stage marks: one thread writes the device's nanosecond clock
// (%globaltimer) into slot i of an int64 buffer.
//
// Replaces no TPU kernel: it is the port's own tracing
// (kbslam_torch/utils/profiling.py). Every CUDA graph the port captures
// goes through device.graph_capture, which puts a mark first and last in
// the graph, and pipeline.track_step and ba.local_ba.local_ba put one at
// each stage edge; so each replay leaves, in the graph's buffer, the time
// at which the device reached each edge, the idle time between kernels
// included. A kernel and not a CUDA event: the chunked stream dispatches
// chunk k + 1 before it reads chunk k, and a graph's events would be
// re-recorded by then, while a buffer is copied out beside each replay's
// output rows.
//
// What bounds it: the launch. It writes 8 bytes; a graph node costs the
// device about a microsecond.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_mark_kernel(int64_t* slots, int i) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    slots[i] = static_cast<int64_t>(t);
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t); returns cudaGetLastError(). The
// Python wrapper checks that slot i lies in the buffer.
int kbslam_stage_mark(int64_t* slots, int i, void* stream) {
    stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slots,
                                                                       i);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
