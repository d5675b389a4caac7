/* The clip pack's gather: frames held at scattered addresses copied, in
 * order, into one contiguous buffer.
 *
 * A temporal engine packs a call's clips (clips x T frames of one shape,
 * the padding's slots pointing at the last clip's frames) into its staging
 * buffer with one call, in place of a numpy stack a clip on one core. The
 * loop runs over the frames with OpenMP when built with -fopenmp; ctypes
 * releases the GIL for the call.
 *
 * Built on demand by native/frames.py (cc -O3 -shared); without a compiler
 * the engine stacks the frames with numpy (the same bytes).
 */

#include <stdint.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

/* dst[k * frame_bytes ...] = src[k][0 .. frame_bytes) for k < n. */
void gather_frames(const uint8_t *const *src, uint8_t *dst, long n,
                   long frame_bytes) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 1)
#endif
    for (long k = 0; k < n; k++)
        memcpy(dst + k * frame_bytes, src[k], (size_t)frame_bytes);
}

/* The threads gather_frames runs on: OpenMP's team size, 1 without it. */
int gather_threads(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}
