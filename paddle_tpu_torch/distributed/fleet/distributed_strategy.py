"""DistributedStrategy (port of
``paddle_tpu/distributed/fleet/distributed_strategy.py``; Paddle's
``distributed_strategy.proto`` as a plain config tree): the hybrid
degrees and their sub-configs, the amp, recompute, sharding and comm
configs, ``to_dict`` / ``from_dict`` for reproducible runs. The degrees
drive the mesh (``mesh.init_mesh``).

``comm_overlap`` (default True) launches each gradient bucket's
collective during backward; False exchanges them at the step boundary.
The reference also reads a process-wide default from
``PADDLE_COMM_OVERLAP``; the port's options are attributes only.
"""
from __future__ import annotations

import copy
import json


_HYBRID_DEFAULTS = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
    "pp_configs": {
        "micro_batch_size": 1,
        "accumulate_steps": 1,
        "schedule_mode": "1F1B",  # FThenB | 1F1B | ZBH1
        "p2p_overlap": True,
    },
    "mp_configs": {
        "sync_param": False,
        "sync_grad": False,
        "sync_moment": False,
    },
    "sharding_configs": {
        "stage": 1,
        "offload": False,
        "segment_size": 2 ** 20,
    },
}

_AMP_DEFAULTS = {
    "init_loss_scaling": 2 ** 15,
    "incr_every_n_steps": 1000,
    "decr_every_n_nan_or_inf": 2,
    "incr_ratio": 2.0,
    "decr_ratio": 0.5,
    "use_dynamic_loss_scaling": True,
    "custom_white_list": [],
    "custom_black_list": [],
    "level": "O1",
    "dtype": "float16",
    "use_fp16_guard": False,
}

_RECOMPUTE_DEFAULTS = {
    "checkpoints": [],
    "enable_offload": False,
}

_COMM_DEFAULTS = {
    "block_size": 256,        # elements per quantization block
    "error_feedback": False,  # carry compression error into the next round
}


def _merge(defaults, override):
    out = copy.deepcopy(defaults)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


class DistributedStrategy:
    def __init__(self):
        self._hybrid_configs = copy.deepcopy(_HYBRID_DEFAULTS)
        self._amp_configs = copy.deepcopy(_AMP_DEFAULTS)
        self._recompute_configs = copy.deepcopy(_RECOMPUTE_DEFAULTS)
        self._sharding_configs = {}
        self.amp = False
        self.recompute = False
        self.sharding = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        # dp-axis meta-optimizers (reference dgc_optimizer / localsgd_
        # optimizer); realized by fleet.meta_optimizers wrappers
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.fuse_all_reduce_ops = True  # the buckets fuse regardless
        self.nccl_comm_num = 1           # accepted; one communicator
        # gradient-communication policy (distributed.comm): fusion bucket
        # size for the imperative dp/sharding exchange (0 → per-tensor),
        # wire quantization scheme (None/"fp32" | "bf16" | "int8"), and
        # codec sub-config
        self.fuse_grad_size_in_MB = 32
        self.comm_quantization = None
        self._comm_configs = copy.deepcopy(_COMM_DEFAULTS)
        # comm/compute overlap (ready-bucket scheduling): each fusion
        # bucket's collective dispatches the moment its last gradient
        # lands in backward; False restores the barrier-at-step exchange
        self.comm_overlap = True
        # auto-parallel mesh search (the reference's cost-model tuner,
        # ROADMAP queue A item 8d: fleet.init refuses it until then)
        self.auto_search = False
        self.auto_search_configs = {}    # model=<cfg>|ModelSpec fields,
        #                                  seq_len, global_batch, chip

    # -- hybrid --------------------------------------------------------------
    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs):
        self._hybrid_configs = _merge(_HYBRID_DEFAULTS, configs)

    @property
    def amp_configs(self):
        return self._amp_configs

    @amp_configs.setter
    def amp_configs(self, configs):
        self._amp_configs = _merge(_AMP_DEFAULTS, configs)

    @property
    def recompute_configs(self):
        return self._recompute_configs

    @recompute_configs.setter
    def recompute_configs(self, configs):
        self._recompute_configs = _merge(_RECOMPUTE_DEFAULTS, configs)

    @property
    def comm_configs(self):
        return self._comm_configs

    @comm_configs.setter
    def comm_configs(self, configs):
        self._comm_configs = _merge(_COMM_DEFAULTS, configs)

    @property
    def sharding_configs(self):
        return self._sharding_configs

    @sharding_configs.setter
    def sharding_configs(self, configs):
        self._sharding_configs = dict(configs)

    def degrees(self):
        h = self._hybrid_configs
        return {
            "dp": int(h["dp_degree"]),
            "pp": int(h["pp_degree"]),
            "sharding": int(h["sharding_degree"]),
            "sep": int(h["sep_degree"]),
            "mp": int(h["mp_degree"]),
        }

    # -- serialization (the proto's job in the reference) --------------------
    def to_dict(self):
        return {
            "hybrid_configs": self._hybrid_configs,
            "amp": self.amp, "amp_configs": self._amp_configs,
            "recompute": self.recompute,
            "recompute_configs": self._recompute_configs,
            "sharding": self.sharding, "sharding_configs": self._sharding_configs,
            "fuse_grad_size_in_MB": self.fuse_grad_size_in_MB,
            "comm_quantization": self.comm_quantization,
            "comm_configs": self._comm_configs,
            "comm_overlap": self.comm_overlap,
        }

    def __repr__(self):
        return "DistributedStrategy(" + json.dumps(self.to_dict(), indent=2) + ")"

    @classmethod
    def from_dict(cls, d):
        s = cls()
        s.hybrid_configs = d.get("hybrid_configs", {})
        s.amp = d.get("amp", False)
        s.amp_configs = d.get("amp_configs", {})
        s.recompute = d.get("recompute", False)
        s.recompute_configs = d.get("recompute_configs", {})
        s.sharding = d.get("sharding", False)
        s.sharding_configs = d.get("sharding_configs", {})
        s.fuse_grad_size_in_MB = d.get("fuse_grad_size_in_MB", 32)
        s.comm_quantization = d.get("comm_quantization", None)
        s.comm_configs = d.get("comm_configs", {})
        s.comm_overlap = d.get("comm_overlap", s.comm_overlap)
        return s
