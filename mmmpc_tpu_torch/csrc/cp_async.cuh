// cp.async wrappers shared by the fused whole-body kernels A and B
// (wholebody_fwd.cu, wholebody_bwd.cu): 4-byte copies from device memory
// into shared memory that fly while the block computes, gathered into
// commit groups and waited for by group.  Pure data movement: no
// arithmetic of either kernel passes through here.
#pragma once

namespace wb {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace wb
