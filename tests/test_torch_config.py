"""The port's training and inference configs against the JAX package's on
the same inputs: duplicate keys in a JSON training config, the
data-parallel keys (``mesh``, ``zero_optimization``, the gradient
reduction's keys) and the batch triangle over the data-parallel world,
and the JAX inference config's keys that need no unported slice."""

import pytest

from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.inference.config import INERT, \
    DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config_utils import \
    dict_raise_error_on_duplicate_keys

DUPLICATE = '{"train_batch_size": 8, "train_batch_size": 16}'


@pytest.mark.parametrize("config_cls", [JaxConfig, DeepSpeedConfig],
                         ids=["jax", "port"])
def test_duplicate_keys_in_a_json_file_raise(tmp_path, config_cls):
    path = tmp_path / "ds_config.json"
    path.write_text(DUPLICATE)
    with pytest.raises(ValueError) as err:
        config_cls(str(path))
    assert str(err.value) == \
        "Duplicate keys in DeepSpeed config: ['train_batch_size']"


def test_a_json_file_without_duplicates_loads(tmp_path):
    path = tmp_path / "ds_config.json"
    path.write_text('{"train_batch_size": 16}')
    assert DeepSpeedConfig(str(path)).train_batch_size == 16
    assert dict_raise_error_on_duplicate_keys([("a", 1), ("b", 2)]) == \
        {"a": 1, "b": 2}


# the JAX inference config's inert keys set to other values than their
# defaults, under their names or their aliases, and the keys whose note
# the port's engine logs
INERT_CASES = {
    "names": (dict(replace_with_kernel_inject=True, enable_cuda_graph=True,
                   triangular_masking=False, return_tuple=False,
                   replace_method="x", transposed_mode=True,
                   training_mp_size=2, set_empty_params=True,
                   config={"hidden": 8}, injection_policy_tuple=("attn",),
                   min_out_tokens=4, max_out_tokens=64, mpu="unit",
                   ep_group="g", tensor_parallel={"tp_size": 1}),
              set(INERT) - {"ep_size", "ep_mp_group", "moe_experts",
                            "moe_type"}),
    "aliases": (dict(kernel_inject=True, tm=False, args={"hidden": 8},
                     min_tokens=3, max_tokens=32, mp_size=1,
                     expert_group="g", expert_mp_group="h"),
                {"replace_with_kernel_inject", "triangular_masking",
                 "config", "min_out_tokens", "ep_group", "ep_mp_group"}),
    # the JAX config moves these into its moe section, which must then be
    # a section (with moe = False its migration fails); the port keeps
    # them where they are (moe is not ported)
    "moe_legacy": (dict(ep_size=2, moe_experts=[4], moe_type="residual"),
                   {"ep_size", "moe_experts", "moe_type"}),
}


@pytest.mark.parametrize("case", list(INERT_CASES))
def test_inference_configs_agree_on_the_jax_keys(case):
    kwargs, noted = INERT_CASES[case]
    jax_extra = {"moe": {"enabled": False}} if "ep_size" in kwargs else {}
    jax = JaxInferenceConfig(**kwargs, **jax_extra)
    port = DeepSpeedInferenceConfig(**kwargs)
    shared = (set(type(port).model_fields) & set(type(jax).model_fields)) \
        - {"dtype"}
    assert set(INERT) | {"max_out_tokens", "tensor_parallel", "mp_size"} \
        <= shared
    for name in shared:
        want = getattr(jax, name)
        got = getattr(port, name)
        if name == "tensor_parallel":
            want, got = want.model_dump(), got.model_dump()
        assert got == want, name
    assert {key for key, _ in port.inert_notes()} == noted


def test_inference_engine_logs_each_inert_key(monkeypatch):
    from deepspeed_tpu_torch.inference import engine

    said = []
    monkeypatch.setattr(engine, "log_dist",
                        lambda msg, ranks=None: said.append(msg))
    engine.InferenceEngine(GPT2LMHeadModel(GPT2Config.tiny()), device="cpu",
                           enable_cuda_graph=True, min_out_tokens=4,
                           return_tuple=True)
    text = "\n".join(said)
    assert "'enable_cuda_graph' has no effect" in text
    assert "'min_out_tokens' has no effect" in text
    # set, but to its default: no note
    assert "'return_tuple'" not in text


@pytest.mark.parametrize("kwargs", [dict(tensor_parallel={"tp_size": 1}),
                                    dict(tp={"tp_size": 1}),
                                    dict(mp_size=1)])
def test_tensor_parallel_size_one_is_accepted(kwargs):
    jax = JaxInferenceConfig(**kwargs)
    port = DeepSpeedInferenceConfig(**kwargs)
    assert port.tensor_parallel.tp_size == jax.tensor_parallel.tp_size == 1


@pytest.mark.parametrize("kwargs", [dict(tensor_parallel={"tp_size": 2}),
                                    dict(tp={"tp_size": 4}),
                                    dict(mp_size=2),
                                    dict(tensor_parallel={"enabled": True},
                                         mp_size=2)])
def test_tensor_parallel_above_one_names_the_multi_gpu_slice(kwargs):
    """Tensor-parallel inference is ported: the port takes these configs
    as JAX does, with the same ``tp_size``."""
    jax = JaxInferenceConfig(**kwargs)
    assert jax.tensor_parallel.tp_size > 1
    port = DeepSpeedInferenceConfig(**kwargs)
    assert port.tensor_parallel.tp_size == jax.tensor_parallel.tp_size
    assert port.tensor_parallel.enabled == jax.tensor_parallel.enabled


def test_unknown_inference_key_still_fails():
    with pytest.raises(Exception, match="Extra inputs"):
        DeepSpeedInferenceConfig(not_a_key=1)


# the data-parallel slice's training keys, each parsed by both packages
# with WORLD_SIZE=4 (the batch triangle's world: 4 / (tp pipe seq fsdp))
DATA_PARALLEL_CASES = {
    "mesh": {"train_micro_batch_size_per_gpu": 2,
             "mesh": {"data": 2, "fsdp": 2}},
    "mesh_fill": {"train_batch_size": 16, "mesh": {"data": -1,
                                                   "fsdp": 2}},
    "model_alias": {"train_micro_batch_size_per_gpu": 1,
                    "mesh": {"model": 1, "data": 4}},
    "zero_stage3": {"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 7,
        "stage3_max_live_parameters": 9, "hierarchical_gather": True,
        "reduce_bucket_size": 1000, "allgather_bucket_size": 2000,
        "offload_optimizer": {"device": "none"}}},
    "zero_deprecated": {"train_batch_size": 8, "zero_optimization": {
        "stage": 2, "stage3_gather_fp16_weights_on_model_save": True,
        "cpu_offload": False}},
    "reduction_keys": {"train_batch_size": 8, "prescale_gradients": True,
                       "gradient_predivide_factor": 2.0,
                       "communication_data_type": "fp32",
                       "disable_allgather": True, "sparse_gradients": True,
                       "zero_allow_untested_optimizer": True},
}


@pytest.mark.parametrize("case", list(DATA_PARALLEL_CASES))
def test_data_parallel_keys_match_jax(case, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    d = DATA_PARALLEL_CASES[case]
    jax, port = JaxConfig(dict(d)), DeepSpeedConfig(dict(d))
    for name in ("world_size", "train_batch_size",
                 "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "prescale_gradients",
                 "gradient_predivide_factor", "communication_data_type",
                 "disable_allgather", "sparse_gradients_enabled",
                 "zero_allow_untested_optimizer", "zero_enabled",
                 "zero_optimization_stage"):
        assert getattr(port, name) == getattr(jax, name), name
    assert port.mesh.model_dump() == jax.mesh.model_dump()
    skip = {"offload_optimizer", "offload_param"}
    assert port.zero_config.model_dump(exclude=skip) == \
        jax.zero_config.model_dump(exclude=skip)


@pytest.mark.parametrize("d,where", [
    ({"mesh": {"tp": 2}}, None), ({"mesh": {"seq": 2}}, r"\[12.7\]"),
    ({"mesh": {"expert": 2}}, r"\[12.6\]"), ({"mesh": {"pipe": 2}},
                                              r"\[11\]"),
    ({"mesh": {"dcn": {"data": 2}}}, None),
    ({"tensor_parallel": {"policy": "gpt2"}}, None),
    ({"comm_quantization": {"enabled": True}}, r"\[9\]"),
    ({"zero_optimization": {"offload_param": {"device": "cpu"}}}, "offload"),
    ({"zero_optimization": {"cpu_offload_param": True}}, "offload")],
    ids=["tp", "seq", "expert", "pipe", "dcn", "tensor_parallel",
         "comm_quantization", "offload_param", "cpu_offload_param"])
def test_keys_of_later_slices_raise_naming_them(d, where):
    """Keys of later slices raise naming them; the tensor-parallel
    training keys (None) are taken, as JAX takes them."""
    jax = JaxConfig({"train_batch_size": 1, **d})  # the JAX package takes
    if where is None:
        port = DeepSpeedConfig({"train_batch_size": 1, **d})
        assert port.mesh.model_dump() == jax.mesh.model_dump()
        assert port.tensor_parallel_config == jax.tensor_parallel_config
        return
    with pytest.raises(NotImplementedError, match=where):
        DeepSpeedConfig({"train_batch_size": 1, **d})


TP_CASES = {
    "tp": {"train_micro_batch_size_per_gpu": 2, "mesh": {"tp": 2}},
    "model_alias": {"train_batch_size": 8, "mesh": {"model": 2}},
    "data_tp": {"train_batch_size": 8, "gradient_accumulation_steps": 2,
                "mesh": {"data": 2, "tp": 2}},
    "fsdp_tp": {"train_micro_batch_size_per_gpu": 4,
                "mesh": {"fsdp": 2, "tp": 2}},
    "policy": {"train_batch_size": 4, "mesh": {"tp": 4},
               "tensor_parallel": {"policy": "gpt2"}},
    "dcn": {"train_batch_size": 4, "mesh": {"data": 4, "dcn": {"data": 2}}},
}


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tensor_parallel_keys_match_jax(case, monkeypatch):
    """mesh.tp, its alias mesh.model, the tensor_parallel section and
    mesh.dcn parse as JAX's DeepSpeedConfig does; the batch triangle's
    world is world / (tp x pipe x seq x fsdp)."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    d = TP_CASES[case]
    jax, port = JaxConfig(dict(d)), DeepSpeedConfig(dict(d))
    for name in ("world_size", "train_batch_size",
                 "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "tensor_parallel_config"):
        assert getattr(port, name) == getattr(jax, name), name
    assert port.mesh.model_dump() == jax.mesh.model_dump()
