"""The port's top-level API against the JAX package's
(``tpu_trainer/__init__.py``), and the lazy exports that keep the
torch-free modules torch-free."""

import subprocess
import sys

import numpy as np
import pytest

import tpu_trainer_torch
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.models.weights import init_params

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=16)


def test_exports_match_the_jax_package():
    import tpu_trainer

    assert set(tpu_trainer_torch.__all__) == set(tpu_trainer.__all__)
    assert tpu_trainer_torch.__version__ == tpu_trainer.__version__
    assert tpu_trainer_torch.GPT is GPT
    assert tpu_trainer_torch.GPTConfig is GPTConfig
    assert tpu_trainer_torch.generate_bucketed is tpu_trainer_torch.generate
    with pytest.raises(AttributeError):
        tpu_trainer_torch.not_an_export


@pytest.mark.parametrize("extra", [{}, {"num_kv_heads": 2},
                                   {"num_experts": 4, "moe_top_k": 2,
                                    "moe_impl": "dropless"}])
def test_count_parameters_matches_jax(extra):
    import jax
    import jax.numpy as jnp
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.models.gpt import GPT as JGPT
    from tpu_trainer.models.gpt import count_parameters as jcount

    jparams = JGPT(JConfig(**TINY, **extra)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY, **extra)
    params = init_params(cfg, 0, device="cpu")
    want = jcount(jparams)
    assert tpu_trainer_torch.count_parameters(params) == want
    assert tpu_trainer_torch.count_parameters(GPT(cfg, device="meta")) == want
    assert tpu_trainer_torch.count_parameters(
        {k: np.asarray(v) for k, v in params.items()}) == want
    assert cfg.num_parameters() == want


@pytest.mark.parametrize("module", ["tpu_trainer_torch.tools.analyze",
                                    "tpu_trainer_torch.utils.schema"])
def test_torch_free_modules_do_not_load_torch(module):
    code = (f"import sys, {module}, tpu_trainer_torch; "
            f"tpu_trainer_torch.__version__; "
            f"assert 'torch' not in sys.modules, 'torch was imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
