"""DistributedStrategy (reference
python/paddle/distributed/fleet/base/distributed_strategy.py + proto at
paddle/fluid/framework/distributed_strategy.proto).  Plain-python config
object — no protobuf needed; the fields mirror the proto's hybrid/amp/
recompute/sharding messages that the TPU build consumes."""

import copy


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "mp_configs": {},
            "pp_configs": {},
        }
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "custom_white_list": [],
            "custom_black_list": [],
            "use_pure_fp16": False,
            "use_bf16": True,
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 8}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1,
                                          "begin_step": 1}
        self.asp = False
        self.fp16_allreduce = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.a_sync = False
        self.a_sync_configs = {}
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.without_graph_optimization = True

    def __deepcopy__(self, memo):
        new = DistributedStrategy()
        for k, v in self.__dict__.items():
            setattr(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self):
        lines = ["DistributedStrategy("]
        for k, v in sorted(self.__dict__.items()):
            lines.append(f"  {k}={v!r},")
        lines.append(")")
        return "\n".join(lines)
