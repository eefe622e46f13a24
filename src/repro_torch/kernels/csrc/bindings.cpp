// The Python module of the hand-written CUDA kernels: the wrappers
// declared in bindings.h (defined in bind_embedding_bag.cpp, bind_sparse.cpp
// and bind_dense.cpp) bound by pybind11.  This is the one source that
// includes the Python binding's headers (the tensor type casters), not
// <torch/extension.h>: the build compiles it beside the wrappers' sources
// in a fraction of the time the whole C++ frontend's headers take.
#include <torch/csrc/utils/pybind.h>

#include "bindings.h"

namespace py = pybind11;
using namespace repro_bind;

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.attr("max_bag_dim") = py::int_(kMaxBagDim);
  m.def("embedding_bag_forward", &embedding_bag_forward,
        "Embedding bag from inv and seg in one call, or its index streams "
        "alone (CUDA)", py::arg("working"), py::arg("inv"), py::arg("seg"),
        py::arg("weights"), py::arg("num_bags"),
        py::arg("streams_only") = false);
  m.def("embedding_bag_walk", &embedding_bag_walk,
        "The embedding bag's walk alone, on index streams in bag order "
        "(CUDA)", py::arg("working"), py::arg("inv_sorted"),
        py::arg("w_sorted"), py::arg("offsets"), py::arg("out"));
  m.def("embedding_bag_backward", &embedding_bag_backward,
        "Working-row gradient of the bag from inv and seg in one call, or "
        "its index streams alone (CUDA)", py::arg("g"), py::arg("inv"),
        py::arg("seg"), py::arg("weights"), py::arg("working_rows"),
        py::arg("streams_only") = false);
  m.def("embedding_bag_weight_grad", &embedding_bag_weight_grad,
        "Per-entry weight gradient of the bag (CUDA)", py::arg("g"),
        py::arg("seg"), py::arg("working"), py::arg("inv"), py::arg("g_w"));
  m.def("sparse_adagrad_apply", &sparse_adagrad_apply,
        "In-place AdaGrad push, the row math in the kernel (CUDA)",
        py::arg("table"), py::arg("accum"), py::arg("uids"), py::arg("grads"),
        py::arg("lr"), py::arg("eps"));
  m.def("sparse_adagrad_cached_apply", &sparse_adagrad_cached_apply,
        "In-place AdaGrad push into the device cache by slot, the row math "
        "in the kernel (CUDA)", py::arg("cache_rows"), py::arg("cache_accum"),
        py::arg("slots"), py::arg("uids"), py::arg("grads"), py::arg("lr"),
        py::arg("eps"));
  m.def("gather_rows_cached", &gather_rows_cached,
        "Row gather from the device cache by slot, with an optional zero "
        "drop row after the rows (CUDA)", py::arg("cache_rows"),
        py::arg("slots"), py::arg("drop_row") = false);
  m.def("sparse_adagrad_staged", &sparse_adagrad_staged,
        "In-place dense-block AdaGrad over staged working-set rows (CUDA)",
        py::arg("rows"), py::arg("accum"), py::arg("grads"), py::arg("lr"),
        py::arg("eps"));
  m.def("fused_adam", &fused_adam,
        "In-place k-step local Adam step over every leaf in one launch "
        "(CUDA)", py::arg("table"), py::arg("grads"), py::arg("t"),
        py::arg("lr_t"), py::arg("lr"), py::arg("mhat"), py::arg("vhat"),
        py::arg("b1"), py::arg("b2"), py::arg("weight_decay"), py::arg("k"),
        py::arg("warmup"));
  m.def("dot_interaction", &dot_interaction,
        "DLRM dot interaction: the strict lower triangle of each instance's "
        "self-Gram (CUDA)", py::arg("feats"), py::arg("out"));
  m.def("dot_interaction_backward", &dot_interaction_backward,
        "DLRM dot interaction's backward: (G + G^T) feats, G the gradient "
        "in the strict lower triangle (CUDA)", py::arg("g"), py::arg("feats"),
        py::arg("out"));
  m.def("flash_attention", &flash_attention,
        "Causal or full GQA softmax attention with the online-softmax "
        "recurrence, forward, with an optional sliding window and chunk, "
        "optionally with the rows' log-sum-exp (CUDA)",
        py::arg("q"), py::arg("k"), py::arg("v"), py::arg("out"),
        py::arg("causal"), py::arg("lse") = py::none(),
        py::arg("window") = 0, py::arg("chunk") = 0);
  m.def("flash_attention_backward", &flash_attention_backward,
        "Causal or full GQA softmax attention's backward: dq, dk, dv from "
        "the forward's output and log-sum-exp, with an optional sliding "
        "window and chunk (CUDA)", py::arg("q"),
        py::arg("k"), py::arg("v"), py::arg("out"), py::arg("dout"),
        py::arg("lse"), py::arg("delta"), py::arg("dq"), py::arg("dk"),
        py::arg("dv"), py::arg("causal"), py::arg("window") = 0,
        py::arg("chunk") = 0);
  m.def("hash_lookup", &hash_lookup,
        "Batch linear probe of the cache's id -> slot hash map (CUDA)",
        py::arg("key_tab"), py::arg("slot_tab"), py::arg("slot_uid"),
        py::arg("uids"));
}
