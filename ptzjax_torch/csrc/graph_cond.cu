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
// This is no port of a TPU kernel: the set kernel does one load and one or
// two handle writes, bound by its launch.
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
