"""auto_parallel Strategy (reference auto_parallel/strategy.py + defaults in
auto_parallel/constants.py): structured config groups with attribute access.
"""


class _ConfigGroup:
    def __init__(self, **defaults):
        self.__dict__.update(defaults)

    def to_dict(self):
        return dict(self.__dict__)

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class AMPConfig(_ConfigGroup):
    def __init__(self):
        super().__init__(enable=False, dtype="float16", level="o1",
                         init_loss_scaling=32768.0, incr_every_n_steps=1000,
                         decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                         decr_ratio=0.8, use_dynamic_loss_scaling=True,
                         custom_white_list=[], custom_black_list=[])


class ShardingConfig(_ConfigGroup):
    def __init__(self):
        super().__init__(enable=False, stage=1, degree=8,
                         overlap_grad_comm=False)


class RecomputeConfig(_ConfigGroup):
    def __init__(self):
        super().__init__(enable=False, checkpoints=None,
                         no_recompute_segments=[])


class GradientMergeConfig(_ConfigGroup):
    def __init__(self):
        super().__init__(enable=False, k_steps=1, avg=True)


class PipelineConfig(_ConfigGroup):
    def __init__(self):
        super().__init__(enable=False, schedule_mode="1F1B",
                         micro_batch_size=1, accumulate_steps=1)


class MPConfig(_ConfigGroup):
    def __init__(self):
        super().__init__(enable=False, degree=1)


class Strategy:
    """Reference Strategy: named config groups, dict round-trip."""

    def __init__(self, config=None):
        self.auto_mode = "semi"
        self.amp = AMPConfig()
        self.sharding = ShardingConfig()
        self.recompute = RecomputeConfig()
        self.gradient_merge = GradientMergeConfig()
        self.pipeline = PipelineConfig()
        self.mp = MPConfig()
        if config:
            for group, values in config.items():
                tgt = getattr(self, group, None)
                if tgt is not None and isinstance(values, dict):
                    tgt.__dict__.update(values)

    def to_dict(self):
        return {name: grp.to_dict() for name, grp in self.__dict__.items()
                if isinstance(grp, _ConfigGroup)}

    def __repr__(self):
        return f"Strategy({self.to_dict()})"
