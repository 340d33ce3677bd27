"""PyTorch port vs the JAX package: ``evaluate`` (the batched eval rollout,
``eval_stream="parallel"``) with SAC's and PPO's actors against
``train.build_eval_rollout``: Mod-EMLP (K9 and K11's plain twins), Mono-EMLP
(the MONO instances' twins) and Mod-MLP (the MLP chains, with K11's head's
twin for PPO).  The TD3 and MONO TD3 evals are held in
``test_torch_slice.py`` and ``test_torch_mono.py``.

Tolerances as ``test_torch_slice.py``'s TD3 check: episode and benchmark
rewards within 1e-5 relative, success identical, the last |ex| and eb1
within 1e-5 (float32 rollouts of 200 ticks from the same initial states).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jtrain
from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch import evaluate as tevaluate
from test_torch_families import ALGOS, _kw
from test_torch_td3 import _cfgs, _np_tree, _t

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# evaluate with SAC and PPO actors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["mod-emlp", "mono-emlp", "mod-mlp"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_evaluate_matches_build_eval_rollout(algo, family):
    """``evaluate`` with SAC's and PPO's deterministic heads (``tanh(mean)``,
    ``clip(mean)``) of seeded flax actors, 10 eval envs x 200 ticks, vs
    ``train.build_eval_rollout`` with ``Learner._build_eval``'s act_eval
    (``train.py:193-206``) from the same initial states: per-agent episode
    reward, benchmark reward, success, last |ex| and eb1."""
    jcfg, tcfg = _cfgs(eval_max_steps=1, **_kw(algo, family))
    _, factory, jagent_cls, jfactory, actor_conv, _ = ALGOS[algo]
    jagents, params, actors = [], [], []
    for i in range(jcfg.n_agents):
        defs = jfactory(jcfg, i)
        jagents.append(jagent_cls(jcfg, i, defs))
        params.append(defs.actor_def.init(
            jax.random.PRNGKey(9 + i),
            jnp.zeros((1, jcfg.obs_dim_n[i]), jnp.float32)))
        actor, _ = factory(tcfg, i, device="cpu")
        actor.load_state_dict(actor_conv(jax.tree.map(np.asarray, params[-1]),
                                         tcfg, i))
        actors.append(actor)

    def act_eval(states, obs):
        acts = []
        for a, p, o in zip(jagents, params, obs):
            if algo == "SAC":
                acts.append(a.choose_action_f(p, o, jax.random.PRNGKey(0),
                                              is_eval=True))
            else:
                acts.append(a.choose_action_f(p, o, None, is_eval=True)[0])
        return jnp.concatenate(acts, axis=-1)
    key = jax.random.PRNGKey(1992)
    ep_j, bench_j, succ_j, ex_j, eb1_j, _ = jtrain.build_eval_rollout(
        jcfg, act_eval)(None, key)
    jbs, jobs = jbatch.batched_reset(jcfg.replace(num_envs=jcfg.num_eval),
                                     key, "eval")
    tbs = convert.env_state_from_numpy(_np_tree(jbs), device="cpu")
    ep_t, bench_t, succ_t, ex_t, eb1_t, _ = tevaluate.evaluate(
        tcfg, actors, generator=torch.Generator().manual_seed(0),
        device="cpu", init=(tbs, tuple(_t(o) for o in jobs)))
    assert succ_t.shape == np.asarray(succ_j).shape == (10, jcfg.n_agents)
    np.testing.assert_allclose(ep_t.numpy(), np.asarray(ep_j), rtol=1e-5)
    np.testing.assert_allclose(float(bench_t), float(bench_j), rtol=1e-5)
    np.testing.assert_array_equal(succ_t.numpy(), np.asarray(succ_j))
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(eb1_t), float(eb1_j), rtol=0, atol=1e-5)
