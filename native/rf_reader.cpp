// Native RF sample demux/convert kernels.
//
// Host-side hot path of the IQ ingestion pipeline: deinterleave typed
// integer sample streams into the float32 (re, im) planes the device runtime
// consumes. This is the counterpart of the reference's C layer
// (/root/reference/sydr/c_functions): where the reference put correlators in
// C, this framework puts them on the accelerator and keeps only the
// host-bound byte wrangling native.
//
// Build: make -C native   (gcc/g++ -O3 -shared -fPIC)

#include <cstdint>

extern "C" {

void demux_int8_complex(const int8_t *raw, long n_samples,
                        float *re, float *im) {
    for (long i = 0; i < n_samples; ++i) {
        re[i] = static_cast<float>(raw[2 * i]);
        im[i] = static_cast<float>(raw[2 * i + 1]);
    }
}

void demux_int16_complex(const int16_t *raw, long n_samples,
                         float *re, float *im) {
    for (long i = 0; i < n_samples; ++i) {
        re[i] = static_cast<float>(raw[2 * i]);
        im[i] = static_cast<float>(raw[2 * i + 1]);
    }
}

void convert_int8_real(const int8_t *raw, long n_samples, float *out) {
    for (long i = 0; i < n_samples; ++i) {
        out[i] = static_cast<float>(raw[i]);
    }
}

void convert_int16_real(const int16_t *raw, long n_samples, float *out) {
    for (long i = 0; i < n_samples; ++i) {
        out[i] = static_cast<float>(raw[i]);
    }
}

}  // extern "C"
