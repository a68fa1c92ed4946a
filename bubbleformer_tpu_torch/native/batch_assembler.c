/* Native batch assembler: sliding-window gather + normalize + layout.
 *
 * The host-side inner loop of the input pipeline: for each sample in a
 * batch, slice `tw` consecutive frames per field out of a trajectory,
 * nearest-neighbor downsample, normalize ((x - diff) / div) and write into
 * the batch tensor in (B, T, C, H', W') layout.
 *
 * Operates on raw float32 trajectory buffers (memory-mapped .npy field
 * caches, see bubbleformer_tpu_torch/data/cache.py), parallelized with
 * OpenMP over (sample, frame, field) tasks, in a team of `num_threads`
 * threads (the OpenMP default where it is 0): a caller that runs several
 * calls at once sizes each team so that together they fill the machine
 * once, not once per call.  Exposed via ctypes: see
 * bubbleformer_tpu_torch/data/native.py, which compiles this file at first
 * use into build/bubbleformer_tpu_torch/ and reports why when no compiler
 * builds it.
 *
 * Each value is (x - diff) / div in float32, one subtraction and one
 * correctly rounded division, which is what the dataset's numpy path
 * computes: the native batches equal the numpy ones bit for bit.  (A
 * multiplication by 1 / div differs from the division by one ulp in about
 * a fifth of the values.)
 *
 * Build: cc -O3 -fopenmp -shared -fPIC batch_assembler.c
 */
#include <stdint.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

/* field_ptrs: C pointers to (T, H, W) float32 trajectory arrays (one per
 * field, all same shape).  starts: per-sample first frame index (length B).
 * out: (B, tw, C, H/factor, W/factor) float32, preallocated.
 * num_threads: the OpenMP team's size, or 0 for the OpenMP default. */
void assemble_windows(const float **field_ptrs, int64_t num_fields,
                      int64_t traj_h, int64_t traj_w, const int64_t *starts,
                      int64_t batch, int64_t tw, int64_t factor,
                      const float *diff, const float *divisor, float *out,
                      int64_t num_threads) {
  const int64_t out_h = traj_h / factor;
  const int64_t out_w = traj_w / factor;
  const int64_t frame_elems = traj_h * traj_w;
  const int64_t out_frame = out_h * out_w;
  const int64_t tasks = batch * tw * num_fields;

#ifdef _OPENMP
  const int team = num_threads > 0 ? (int)num_threads : omp_get_max_threads();
#pragma omp parallel for schedule(static) num_threads(team)
#else
  (void)num_threads;
#endif
  for (int64_t task = 0; task < tasks; ++task) {
    const int64_t b = task / (tw * num_fields);
    const int64_t t = (task / num_fields) % tw;
    const int64_t c = task % num_fields;

    const float *src = field_ptrs[c] + (starts[b] + t) * frame_elems;
    float *dst = out + ((b * tw + t) * num_fields + c) * out_frame;
    const float d = diff[c];
    const float v = divisor[c];

    if (factor == 1) {
      for (int64_t i = 0; i < frame_elems; ++i) {
        dst[i] = (src[i] - d) / v;
      }
    } else {
      for (int64_t y = 0; y < out_h; ++y) {
        const float *row = src + (y * factor) * traj_w;
        float *orow = dst + y * out_w;
        for (int64_t x = 0; x < out_w; ++x) {
          orow[x] = (row[x * factor] - d) / v;
        }
      }
    }
  }
}

/* Streaming per-field statistics for normalization constants:
 * one pass computing sum, sum of squares, min, max over a (T, H, W) buffer.
 * Results: out[0]=sum, out[1]=sumsq, out[2]=min, out[3]=max. */
void field_stats(const float *data, int64_t count, double *out) {
  double total = 0.0, total_sq = 0.0;
  float vmin = data[0], vmax = data[0];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : total, total_sq)     \
    reduction(min : vmin) reduction(max : vmax)
#endif
  for (int64_t i = 0; i < count; ++i) {
    const float v = data[i];
    total += v;
    total_sq += (double)v * v;
    if (v < vmin) vmin = v;
    if (v > vmax) vmax = v;
  }
  out[0] = total;
  out[1] = total_sq;
  out[2] = vmin;
  out[3] = vmax;
}
