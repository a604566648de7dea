#include "common.cuh"

WEBP_API const char* webp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
