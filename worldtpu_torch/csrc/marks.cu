// Stage marks: an empty kernel at the entry and one at the exit of each
// stage of the main path and of the long-audio chunk step and prescan,
// launched by worldtpu_torch/tracing.py's stage().
//
// Replaces no TPU kernel: the JAX package names its stages for XLA's
// profiler, whose trace splits even a jitted program by its named scopes.
// A captured CUDA graph runs no Python, so the host ranges that name the
// port's stages are not there when it replays.  The marks are nodes of the
// graph: every replay runs them, and a profiler records them on the
// device's clock around the kernels of their stage.  A mark reads and
// writes nothing, so no output changes; each is one empty <<<1, 1>>> block
// (~1-2 us as a graph node), 26 a main-path batch, 10 a long-audio chunk
// step, 2 a prescan step, 24 a feature batch (batch_features: the
// analysis' 22 and the codec's 2).
//
// WT_STAGES is the one list of the stage names, in main-path order, the
// long-audio stages after them, then the feature path's codec (each
// appended: every earlier mark keeps its index);
// tracing.STAGES equals it (tests/test_torch_tracing.py).  Mark 2 i is
// stage i's entry (wt_mark_<stage>_in), mark 2 i + 1 its exit
// (wt_mark_<stage>_out).  The names start with "wt_mark_": a profiler's
// device events named "wt." are the host ranges' shadows, which readers
// drop.

#include <cuda_runtime.h>

#define WT_STAGES(X) \
  X(decimate)        \
  X(band_filter)     \
  X(zc)              \
  X(detect_overlap)  \
  X(refine_prepare)  \
  X(refine_sums)     \
  X(refine_finish)   \
  X(prune)           \
  X(contour)         \
  X(cheaptrick)      \
  X(d4c)             \
  X(pulse_train)     \
  X(ola)             \
  X(long_prescan)    \
  X(long_analysis)   \
  X(long_timebase)   \
  X(long_noise)      \
  X(long_pulses)     \
  X(long_ola)        \
  X(codec)

#define WT_MARK_KERNELS(name)                         \
  extern "C" __global__ void wt_mark_##name##_in() {} \
  extern "C" __global__ void wt_mark_##name##_out() {}
WT_STAGES(WT_MARK_KERNELS)

#define WT_MARK_ENTRY(name) \
  (const void*)wt_mark_##name##_in, (const void*)wt_mark_##name##_out,
static const void* const kMarks[] = {WT_STAGES(WT_MARK_ENTRY)};

static const int kMarkCount = (int)(sizeof(kMarks) / sizeof(kMarks[0]));

// Launch mark `mark` (2 * stage + 0 at entry, + 1 at exit) on `stream`.
extern "C" int wt_mark(int mark, void* stream) {
  if (mark < 0 || mark >= kMarkCount) return (int)cudaErrorInvalidValue;
  cudaLaunchKernel(kMarks[mark], dim3(1), dim3(1), nullptr, 0,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
