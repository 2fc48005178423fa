"""Inference API — Config / create_predictor / zero-copy handles (port
of ``paddle_tpu/inference/__init__.py``).

Reference: AnalysisPredictor (paddle/fluid/inference/api/
analysis_predictor.cc — load → OptimizeInferenceProgram → zero-copy
Run) and paddle_inference_api.h.

The predictor runs one cached ``jit.StaticFunction`` program per input
signature (the JAX package's one jitted executable per signature), with
the model's live weights on every run, on the device the model's
parameters live on (the card unless the model was built or loaded on
the CPU).  ``enable_mixed_precision`` casts the floating parameters
once at build and the floating feeds at each run.  The zero-copy handle
API is kept: ``copy_from_cpu`` stages an input, ``run()`` executes the
program, ``copy_to_cpu`` fetches (a bfloat16 output comes back as
float32, which numpy can hold exactly).  Feeds bind by their declared
names.  A reference-format artifact (a ProgramDesc ``.pdmodel``) serves
through ``load_inference_model(...).to_layer()``, its feeds and fetches
named as the program names them.
"""

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.dtype import convert_dtype


class Config:
    """AnalysisConfig parity (the knobs that are meaningful here)."""

    def __init__(self, model_path=None, params_path=None):
        # model_path: jit.save prefix (model_path + '.pdmodel' must exist)
        self.model_path = model_path
        self.params_path = params_path
        self._model_obj = None
        self.memory_optimized = True
        self._enable_profile = False
        self._precision = "float32"
        self._dist_mesh = None
        self._dist_batch_axis = "dp"

    def set_model(self, model_path, params_path=None):
        self.model_path = model_path
        self.params_path = params_path

    def set_model_obj(self, layer):
        """Direct in-process model (skip serialization)."""
        self._model_obj = layer

    def enable_profile(self):
        self._enable_profile = True

    def enable_mixed_precision(self, dtype="bfloat16"):
        """Convert-to-mixed-precision pass parity
        (paddle/fluid/inference/analysis/passes convert_to_mixed_precision):
        float parameters are cast once at predictor build, activations run
        in ``dtype``."""
        self._precision = dtype

    def enable_dist_inference(self, mesh, batch_axis="dp"):
        """Distributed inference over a rank mesh (``fleet.build_mesh``;
        reference DistModel / dist inference over FleetExecutor): the
        Predictor of each rank runs its block of the batch (dim 0 split
        over ``batch_axis``'s group, parameters replicated) and the
        outputs are all-gathered, so every rank returns the whole
        batch's.  The JAX package shards the inputs of one program over
        the devices of a jax Mesh."""
        self._dist_mesh = mesh
        self._dist_batch_axis = batch_axis

    def switch_ir_optim(self, flag=True):
        pass  # the traced program is what runs

    def enable_memory_optim(self, flag=True):
        self.memory_optimized = flag

    def disable_glog_info(self):
        pass

    def model_dir(self):
        return self.model_path


class _IOHandle:
    """Zero-copy tensor handle (reference ZeroCopyTensor)."""

    def __init__(self, name):
        self.name = name
        self._host = None
        self._result = None

    def reshape(self, shape):
        pass  # shapes flow from copy_from_cpu

    def copy_from_cpu(self, arr):
        self._host = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return np.asarray(self._result)

    def shape(self):
        src = self._result if self._result is not None else self._host
        return list(src.shape) if src is not None else []


def _host(o):
    data = o._data if isinstance(o, Tensor) else o
    if isinstance(data, torch.Tensor):
        data = data.detach()
        if data.dtype == torch.bfloat16:
            data = data.float()
        return data.cpu().numpy()
    return np.asarray(data)


class Predictor:
    def __init__(self, config):
        from ..jit import StaticFunction

        self._config = config
        if config._model_obj is not None:
            self._model = config._model_obj
            feed_names, fetch_names = ["x0"], ["out0"]
        else:
            # the sniffing loader routes both formats: this package's
            # jit.save artifacts and reference ProgramDesc exports — the
            # latter wrap as a Layer (``to_layer``), so the precision pass
            # and the traced program apply uniformly
            from ..static import load_inference_model
            loaded, feeds, fetches = load_inference_model(
                config.model_path)
            self._model = loaded.to_layer() if hasattr(
                loaded, "to_layer") else loaded
            feed_names, fetch_names = list(feeds), list(fetches)
        self._model.eval()
        # the program's DECLARED feed order: get_input_handle(name) +
        # run() bind by these names, so handles filled in any order feed
        # the right slots (reference ZeroCopyTensor is name-addressed)
        self._inputs = [_IOHandle(n) for n in feed_names]
        self._outputs = [_IOHandle(n) for n in fetch_names]

        # mixed-precision convert pass: cast float params ONCE
        self._target = None
        if config._precision in ("bfloat16", "float16"):
            self._target = convert_dtype(config._precision)
            for p in self._model.state_dict().values():
                data = getattr(p, "_data", None)
                if data is not None and data.is_floating_point():
                    p._data = data.detach().to(self._target)
        model = self._model
        # one traced program per input signature, live weights each run
        self._program = StaticFunction(lambda *xs: model(*xs), layer=model)

    def _device(self):
        for p in self._model.state_dict().values():
            return p._data.device
        return torch.device("cpu")

    # ------------------------------------------------------------- handles --
    def get_input_names(self):
        return [h.name for h in self._inputs]

    def get_output_names(self):
        return [h.name for h in self._outputs]

    def get_input_handle(self, name):
        for h in self._inputs:
            if h.name == name:
                return h
        h = _IOHandle(name)
        self._inputs.append(h)
        return h

    def get_output_handle(self, name):
        for h in self._outputs:
            if h.name == name:
                return h
        raise KeyError(name)

    # --------------------------------------------------------------- run ----
    def _run_tensors(self, datas):
        """Run the program on torch tensors already on the device;
        returns the outputs as torch tensors on the device."""
        if self._target is not None:
            datas = [d.to(self._target) if d.is_floating_point() else d
                     for d in datas]
        group = self._batch_group()
        if group is not None:
            datas = [_rank_block(d, group) for d in datas]
        with torch.no_grad():
            out = self._program(*[_wrap(d) for d in datas])
        outs = out if isinstance(out, (tuple, list)) else (out,)
        outs = [o._data if isinstance(o, Tensor) else o for o in outs]
        if group is not None:
            from ..distributed.fleet.meta_parallel import mp_layers
            outs = [mp_layers.all_gather(o, group, 0) for o in outs]
        return outs

    def _batch_group(self):
        """The group the batch splits over (``enable_dist_inference``),
        None for one rank."""
        mesh = self._config._dist_mesh
        if mesh is None or mesh.axis_size(self._config._dist_batch_axis) \
                <= 1:
            return None
        return mesh.group(self._config._dist_batch_axis)

    def run(self, inputs=None):
        """Either positional (list of np arrays -> list of np arrays) or
        handle-style (copy_from_cpu beforehand, copy_to_cpu after)."""
        if inputs is not None:
            arrays = [np.asarray(a) for a in inputs]
        else:
            # declared-feed order, independent of handle fill order
            missing = [h.name for h in self._inputs if h._host is None]
            if missing:
                raise ValueError(
                    f"feeds {missing} have no data "
                    f"(copy_from_cpu the full declared set "
                    f"{[h.name for h in self._inputs]})")
            arrays = [h._host for h in self._inputs]
        dev = self._device()
        datas = [torch.as_tensor(a, device=dev) for a in arrays]
        host = [_host(o) for o in self._run_tensors(datas)]
        while len(self._outputs) < len(host):
            self._outputs.append(_IOHandle(f"out{len(self._outputs)}"))
        for h, o in zip(self._outputs, host):
            h._result = o
        if inputs is not None:
            return host
        return True


def _rank_block(d, group):
    n = d.shape[0]
    if n % group.nranks:
        raise ValueError(f"batch {n} does not split over the "
                         f"{group.nranks} ranks of the batch axis")
    k = n // group.nranks
    return d[group.rank * k:(group.rank + 1) * k]


def create_predictor(config):
    """Reference CreatePaddlePredictor/create_predictor entry."""
    return Predictor(config)


def get_fused_multi_transformer(model, **kwargs):
    """KV-cache fused decoder for generative inference (see
    incubate.nn.FusedMultiTransformer)."""
    from ..incubate.nn import FusedMultiTransformer
    return FusedMultiTransformer(model, **kwargs)


def create_llm_engine(model, **kwargs):
    """Continuous-batching generative serving engine over a paged KV
    cache (see inference.llm.LLMEngine).  All LLMEngine kwargs pass
    through (``dtype=``, ``quantize=``, ``device=``, ``seed=`` ...)."""
    from .llm import LLMEngine
    return LLMEngine(model, **kwargs)


from . import serving  # noqa: E402,F401
from .serving import PredictorServer  # noqa: E402,F401
