// Conditional nodes of CUDA graphs (CUDA 12.3 and later), for the frame
// program of the tracking loops (ptzjax_torch/_graphs.py).
//
// The reference runs a frame as one device program whose lax.conds pick
// relocalize or track, and insert or not (ptzjax/slam.py:_frame_step). Here
// each branch is captured by torch as a CUDA graph of its own; these entry
// points assemble them into one parent graph whose IF nodes pick the branch
// on the card: a one-thread kernel reads a bool predicate from device memory
// and sets the IF nodes' handles, and each IF node's body holds the branch
// as a child-graph node. No host decision remains inside the frame.
//
// The stamp kernels mark the frame's stage boundaries (ptzjax_torch/_trace.py):
// one thread reads the card's nanosecond clock (%globaltimer) and writes
// into the frame graph's int64 stats buffer. Each boundary is a kernel of
// its own name (stamp_track_predict, ...), so a profiled trace names it.
//
// This is no port of a TPU kernel: the set kernel does one load and one or
// two handle writes, the stamp kernel a few loads and stores, both bound by
// their launch.
//
// Every entry point returns a cudaError_t as an int (0 on success); "last"
// is the node a new node follows (none where *last is null), and becomes the
// new node, so that one chain of calls builds a sequence.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle on_true,
                                       cudaGraphConditionalHandle on_false,
                                       const bool* pred, int has_false) {
  const unsigned int p = *pred ? 1u : 0u;
  cudaGraphSetConditional(on_true, p);
  if (has_false) cudaGraphSetConditional(on_false, 1u - p);
}

// The stamps, in the order of ptzjax_torch/_trace.py's STAMPS: (name, the
// branch whose count the stamp adds 1 to or -1, its role). A stamp ends the
// stage named by it: it adds the time since the last stamp to its sum. The
// frame's first stamp ends no stage and opens the frame's row; its last
// closes the row. The clock stamp only keeps the time: launched while the
// card is idle, it gives the host the offset between the card's clock and
// its own.
#define PTZ_STAMPS(X)                                 \
  X(frame_start, -1, kOpens)                          \
  X(track_frontend, -1, kEnds)                        \
  X(track_predict, -1, kEnds)                         \
  X(track_association, -1, kEnds)                     \
  X(track_update, -1, kEnds)                          \
  X(track_map, -1, kEnds)                             \
  X(track_tail, 1, kEnds)                             \
  X(insert_ba_keyframe, -1, kEnds)                    \
  X(insert_ba_merge, -1, kEnds)                       \
  X(insert_ba_ba, -1, kEnds)                          \
  X(insert_ba_tail, 2, kEnds)                         \
  X(insert_keyframe, -1, kEnds)                       \
  X(insert_merge, -1, kEnds)                          \
  X(insert_tail, 3, kEnds)                            \
  X(lost_frontend, -1, kEnds)                         \
  X(lost_reloc, -1, kEnds)                            \
  X(lost_tail, 0, kEnds)                              \
  X(frame_end, -1, kCloses)                           \
  X(clock, -1, kClock)

enum Role { kOpens, kEnds, kCloses, kClock };

#define PTZ_COUNT(name, branch, role) +1
constexpr int kStamps = 0 PTZ_STAMPS(PTZ_COUNT);

// The stats buffer (int64): [0, 4) the frames that took each branch; kLast
// the last stamp; kRow the frames stamped since the buffer was zeroed;
// kSum0 + k the nanoseconds of the stage that stamp k ends; from kRow0 each
// frame's (first, last) stamp, for the first kRows frames.
constexpr int kLast = 4, kRow = 5, kSum0 = 6, kRow0 = kSum0 + kStamps, kRows = 256;

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

template <int K, int Branch, Role R>
__device__ __forceinline__ void stamp_at(long long* s) {
  const long long now = globaltimer();
  const long long row = s[kRow];
  if (R == kClock) {
    s[kLast] = now;
    return;
  }
  if (R == kOpens) {
    if (row < kRows) s[kRow0 + 2 * row] = now;
  } else {
    s[kSum0 + K] += now - s[kLast];
  }
  if (Branch >= 0) s[Branch] += 1;
  if (R == kCloses) {
    if (row < kRows) s[kRow0 + 2 * row + 1] = now;
    s[kRow] = row + 1;
  }
  s[kLast] = now;
}

enum Index {
#define PTZ_INDEX(name, branch, role) kIndex_##name,
  PTZ_STAMPS(PTZ_INDEX)
};

#define PTZ_KERNEL(name, branch, role) \
  __global__ void stamp_##name(long long* s) { stamp_at<kIndex_##name, branch, role>(s); }
PTZ_STAMPS(PTZ_KERNEL)

#define PTZ_ENTRY(name, branch, role) (const void*)stamp_##name,
const void* const kStampKernels[] = {PTZ_STAMPS(PTZ_ENTRY)};

// the dependency list of a node that follows *last
size_t follow(void** last, cudaGraphNode_t* dep) {
  *dep = (cudaGraphNode_t)*last;
  return *dep ? 1 : 0;
}

// `err` as an int, the thread's last error cleared where it is one, so that
// the next launch's check does not report it again
int done(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" int ptz_graph_create(void** graph) {
  return done(cudaGraphCreate((cudaGraph_t*)graph, 0));
}

// A handle of an IF node in `graph`, reset to 0 at every launch.
extern "C" int ptz_graph_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  cudaError_t err = cudaGraphConditionalHandleCreate(
      &h, (cudaGraph_t)graph, 0, cudaGraphCondAssignDefault);
  *handle = h;
  return done(err);
}

// A kernel node that sets `on_true` to *pred and, where has_false, `on_false`
// to !*pred, both from one read.
extern "C" int ptz_graph_add_set(void* graph, void** last,
                                 unsigned long long on_true,
                                 unsigned long long on_false, int has_false,
                                 const void* pred) {
  cudaGraphConditionalHandle t = on_true, f = on_false;
  const bool* p = (const bool*)pred;
  void* args[] = {&t, &f, &p, &has_false};
  cudaKernelNodeParams params = {};
  params.func = (void*)set_conditional_kernel;
  params.gridDim = dim3(1);
  params.blockDim = dim3(1);
  params.kernelParams = args;
  cudaGraphNode_t dep, node;
  size_t n = follow(last, &dep);
  cudaError_t err = cudaGraphAddKernelNode(&node, (cudaGraph_t)graph, n ? &dep : nullptr, n, &params);
  if (err == cudaSuccess) *last = node;
  return done(err);
}

// A kernel node of the stamp `k` (ptzjax_torch/_trace.py's STAMPS) on the
// stats buffer `stats`.
extern "C" int ptz_graph_add_stamp(void* graph, void** last, int k, void* stats) {
  if (k < 0 || k >= kStamps) return (int)cudaErrorInvalidValue;
  long long* s = (long long*)stats;
  void* args[] = {&s};
  cudaKernelNodeParams params = {};
  params.func = (void*)kStampKernels[k];
  params.gridDim = dim3(1);
  params.blockDim = dim3(1);
  params.kernelParams = args;
  cudaGraphNode_t dep, node;
  size_t n = follow(last, &dep);
  cudaError_t err = cudaGraphAddKernelNode(&node, (cudaGraph_t)graph, n ? &dep : nullptr, n, &params);
  if (err == cudaSuccess) *last = node;
  return done(err);
}

// The stamp `k` on `stream`, for a capture or an eager run.
extern "C" int ptz_stamp(int k, void* stats, void* stream) {
  if (k < 0 || k >= kStamps) return (int)cudaErrorInvalidValue;
  long long* s = (long long*)stats;
  void* args[] = {&s};
  return done(cudaLaunchKernel(kStampKernels[k], dim3(1), dim3(1), args, 0, (cudaStream_t)stream));
}

// An IF node on `handle`; *body receives its body graph, owned by the node.
extern "C" int ptz_graph_add_if(void* graph, void** last, unsigned long long handle, void** body) {
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t dep, node;
  size_t n = follow(last, &dep);
  cudaError_t err = cudaGraphAddNode(&node, (cudaGraph_t)graph, n ? &dep : nullptr, n, &params);
  if (err == cudaSuccess) {
    *last = node;
    *body = params.conditional.phGraph_out[0];
  }
  return done(err);
}

// A child-graph node holding a copy of `child`.
extern "C" int ptz_graph_add_child(void* graph, void** last, void* child) {
  cudaGraphNode_t dep, node;
  size_t n = follow(last, &dep);
  cudaError_t err = cudaGraphAddChildGraphNode(
      &node, (cudaGraph_t)graph, n ? &dep : nullptr, n, (cudaGraph_t)child);
  if (err == cudaSuccess) *last = node;
  return done(err);
}

// Instantiate `graph`. On failure *result holds the cudaGraphInstantiateResult
// and *node_type the type of the node at fault (-1 where none is named).
extern "C" int ptz_graph_instantiate(void* graph, void** exec, int* result, int* node_type, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return done(err);
  cudaGraphInstantiateParams params = {};
  err = cudaGraphInstantiateWithParams((cudaGraphExec_t*)exec, (cudaGraph_t)graph, &params);
  *result = (int)params.result_out;
  *node_type = -1;
  cudaGraphNodeType type;
  if (params.errNode_out && cudaGraphNodeGetType(params.errNode_out, &type) == cudaSuccess)
    *node_type = (int)type;
  return done(err);
}

extern "C" int ptz_graph_launch(void* exec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return done(err);
  return done(cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream));
}

extern "C" int ptz_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph && err == cudaSuccess) err = cudaGraphDestroy((cudaGraph_t)graph);
  return done(err);
}

// *status: 0 = not capturing, 1 = capturing, 2 = a capture that an error
// invalidated (cudaStreamCaptureStatus).
extern "C" int ptz_capture_status(void* stream, int* status) {
  cudaStreamCaptureStatus s = cudaStreamCaptureStatusNone;
  cudaError_t err = cudaStreamIsCapturing((cudaStream_t)stream, &s);
  *status = (int)s;
  return done(err);
}
