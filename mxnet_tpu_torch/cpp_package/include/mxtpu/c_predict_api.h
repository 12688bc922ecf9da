/*
 * C prediction ABI over exported artifacts, on libtorch.
 *
 * The port of the reference's cpp-package/include/mxtpu/c_predict_api.h:
 * the same 13 functions under the same names, with the same conventions:
 *   - every function returns 0 on success, -1 on failure;
 *   - MXTPUPredGetLastError() returns the failing call's message
 *     (thread-local, valid until the thread's next failing call);
 *   - shape pointers returned by GetInput/OutputShape stay valid until
 *     the next call on the same handle;
 *   - inputs are addressed by index in the artifact's signature order.
 *
 * Where the reference's MXTPUPredCreate takes a PJRT plugin .so, this one
 * takes a device name ("cuda:0", "cuda", "cpu"): the artifact carries an
 * AOTInductor package for that device (aoti/<cuda|cpu>.pt2, made by
 * mxnet_tpu_torch.predict.compile_for_cpp), run by libtorch. The
 * `opt_specs` of the reference (PJRT client options) are not used here;
 * they may be NULL / 0.
 */
#ifndef MXTPU_C_PREDICT_API_H_
#define MXTPU_C_PREDICT_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* MXTPUPredictorHandle;

/* Thread-local message of this thread's most recent failing call. */
const char* MXTPUPredGetLastError(void);

/* Create a predictor from an artifact on a device ("cuda:0", "cpu").
 * opt_specs / num_opts: not used (NULL / 0). */
int MXTPUPredCreate(const char* artifact_path,
                    const char* device,
                    const char* const* opt_specs,
                    int num_opts,
                    MXTPUPredictorHandle* out);

/* "gpu" or "cpu". Owned by the handle, valid until MXTPUPredFree. */
int MXTPUPredGetPlatform(MXTPUPredictorHandle handle, const char** name);

int MXTPUPredGetInputCount(MXTPUPredictorHandle handle, int* count);
int MXTPUPredGetOutputCount(MXTPUPredictorHandle handle, int* count);

/* Shape/dtype of one input/output slot. dtype_name receives a static
 * string ("f32", "bf16", "s32", ...); pass NULL for fields you don't
 * need. shape_data stays valid until the next call on this handle. */
int MXTPUPredGetInputShape(MXTPUPredictorHandle handle, int index,
                           const int64_t** shape_data, int* ndim,
                           const char** dtype_name);
int MXTPUPredGetOutputShape(MXTPUPredictorHandle handle, int index,
                            const int64_t** shape_data, int* ndim,
                            const char** dtype_name);

/* Stage input `index` for the next forward. `size` counts f32 elements
 * (checked against the signature); the slot must be f32-typed. */
int MXTPUPredSetInput(MXTPUPredictorHandle handle, int index,
                      const float* data, uint64_t size);

/* Raw-bytes variant for other dtypes: `nbytes` must equal the slot's
 * signature byte size. */
int MXTPUPredSetInputBytes(MXTPUPredictorHandle handle, int index,
                           const void* data, uint64_t nbytes);

/* Run one forward over the staged inputs (all slots must be set; they
 * stay staged for repeated Forward calls). */
int MXTPUPredForward(MXTPUPredictorHandle handle);

/* Copy output `index` of the last Forward: the element-count-checked f32
 * variant and the raw-bytes variant. */
int MXTPUPredGetOutput(MXTPUPredictorHandle handle, int index,
                       float* data, uint64_t size);
int MXTPUPredGetOutputBytes(MXTPUPredictorHandle handle, int index,
                            void* data, uint64_t nbytes);

int MXTPUPredFree(MXTPUPredictorHandle handle);

#ifdef __cplusplus
}
#endif

#endif /* MXTPU_C_PREDICT_API_H_ */
