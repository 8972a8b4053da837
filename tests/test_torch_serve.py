"""The port's lock-step serving lane against the JAX ``Server``.

The port draws the params (``init_params``), they cross to JAX through
``params_to_numpy``, and both packages serve the same ``default_rng``
prompts in f32: the greedy token matrices must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import ExperimentSpec, ServeJob, run    # noqa: E402
from repro_torch.distributed import Server as TServer        # noqa: E402
from repro_torch.distributed import ServeConfig as TServeConfig  # noqa: E402
from repro_torch.models import init_params, params_to_numpy  # noqa: E402
from torch_parity import jax_serve, to_jax                   # noqa: E402


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_tokens_identical_to_jax(flash):
    T, seed = 8, 3
    job = ServeJob(arch="qwen2-0.5b", batch=3, prompt_len=12,
                   arch_overrides=(("dtype", "float32"),
                                   ("use_flash_attention", flash)))
    res = run(ExperimentSpec(objective=job, T=T, seed=seed), device="cpu")
    assert res.x.shape == (3, T) and res.x.dtype == np.int32
    assert res.extra["flash_launches"] == 0          # CPU: plain version
    assert res.extra["logits_finite"]

    params = init_params(job.make_arch(), seed, device="cpu")
    prompts, want = jax_serve(job, T, seed, to_jax(params_to_numpy(params)))
    np.testing.assert_array_equal(res.extra["prompts"], prompts)
    np.testing.assert_array_equal(res.x, want)


def test_sampling_generator_is_threaded_across_calls():
    job = ServeJob(batch=2, prompt_len=4)
    cfg = job.make_arch()
    params = init_params(cfg, 0, device="cpu")
    srv = TServer(cfg, TServeConfig(batch=2, ctx_len=32, temperature=1.0,
                                    seed=5), device="cpu")
    first = srv.generate(params, np.array([1, 2]), 8)
    second = srv.generate(params, np.array([1, 2]), 8)
    assert not np.array_equal(first, second)         # fresh draws
    g = torch.Generator().manual_seed(5)
    again = srv.generate(params, np.array([1, 2]), 8, generator=g)
    np.testing.assert_array_equal(again, first)      # explicit: reproducible
    third = srv.generate(params, np.array([1, 2]), 8)
    assert not np.array_equal(third, second)         # own stream untouched


def test_slot_lane_knobs_raise():
    """The slot lane's knobs construct, the resilience knobs among them;
    values the JAX package refuses raise."""
    job = ServeJob(n_slots=2, n_requests=5, admission="fedbuff:b=2",
                   arrival="poisson:gap=2", steps_per_launch=4, deadline=3)
    assert job.n_slots == 2
    for kw in (dict(max_retries=2), dict(queue_cap=4), dict(drain_after=8)):
        assert ServeJob(n_slots=2, **kw).n_slots == 2
    for kw, match in ((dict(max_retries=0), "max_retries"),
                      (dict(queue_cap=0), "queue_cap"),
                      (dict(drain_after=-1), "drain_after"),
                      (dict(retry_backoff=-1), "retry_backoff")):
        with pytest.raises(ValueError, match=match):
            ServeJob(n_slots=2, **kw)
    with pytest.raises(ValueError, match="n_slots"):
        ServeJob(queue_cap=4)
    with pytest.raises(ValueError, match="admission"):
        ServeJob(admission="nope")
