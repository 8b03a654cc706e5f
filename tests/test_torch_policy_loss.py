"""Port parity: the policy-loss head (K9's plain version), both modes.

* PPO mode against the JAX ``rl/ppo.py:_ppo_loss`` under
  ``jax.value_and_grad`` with the identity ``apply_fn`` (``params`` are the
  logits and the value themselves, so the JAX gradients are d loss / d
  logits and d loss / d value): the value clip on and off, the minibatch
  advantage normalization, the per-preference one, no normalization, and
  the scalar and per-preference KL anchor.  Ratios and values are spread so
  both clips are active on some rows.
* CE mode against ``rl/bc.py:bc_step`` (entropy bonus 0.1) and
  ``rl/dagger.py:_bc_batch_step`` (0 and 0.3), run with the identity
  ``apply_fn`` and ``optax.sgd(1.0)``, so new - old params = -grad.
* The written-out gradients against autograd of the same plain loss.

Tolerance 1e-5 (relative and absolute): the minibatch means are sums in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mansy_immersivevideostreaming_tpu.rl import bc as JB
from mansy_immersivevideostreaming_tpu.rl import dagger as JD
from mansy_immersivevideostreaming_tpu.rl import ppo as JP
from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9

B, A, PREFS = 96, 15, 4
TOL = 1e-5
identity = lambda p, o: (p["logits"], p["value"])

VARIANTS = {
    "clip_norm": dict(cfg={}),
    "no_value_clip": dict(cfg=dict(value_clip=False)),
    "no_norm": dict(cfg=dict(norm_adv=False)),
    "per_pref": dict(cfg=dict(norm_adv_per_pref=True), pref=True),
    "kl_scalar": dict(cfg={}, kl=0.7),
    "kl_per_pref": dict(cfg=dict(norm_adv_per_pref=True), pref=True,
                        kl=np.asarray([2.0, 1.0, 0.1, 0.5], np.float32)),
}


def batch(seed: int):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, A)).astype(np.float32)
    action = rng.integers(0, A, B).astype(np.int32)
    logp = np.asarray(jax.nn.log_softmax(logits))[np.arange(B), action]
    value = rng.normal(0, 1, B).astype(np.float32)
    return dict(logits=logits, value=value, action=action,
                log_prob=(logp + rng.normal(0, 0.3, B)).astype(np.float32),
                old_value=(value + rng.normal(0, 0.3, B)).astype(np.float32),
                adv=rng.normal(0.5, 2.0, B).astype(np.float32),
                ret=rng.normal(0, 1.5, B).astype(np.float32),
                pref_id=rng.integers(0, PREFS, B).astype(np.int32),
                anchor=rng.normal(0, 1.5, (B, A)).astype(np.float32))


def port_spec(b, cfg, v):
    t = lambda k: torch.as_tensor(b[k])
    kl = v.get("kl")
    return K9.LossSpec(
        action=t("action"), ent_coef=0.02, old_log_prob=t("log_prob"), old_value=t("old_value"),
        adv=t("adv"), ret=t("ret"), pref_id=t("pref_id") if v.get("pref") else None,
        anchor_logits=t("anchor") if kl is not None else None,
        kl_coef=None if kl is None else torch.as_tensor(kl, dtype=torch.float32),
        eps_clip=cfg.eps_clip, vf_coef=cfg.vf_coef, value_clip=cfg.value_clip,
        norm_adv=cfg.norm_adv, norm_adv_per_pref=cfg.norm_adv_per_pref, n_prefs=PREFS,
        mode="ppo")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ppo_mode_matches_jax_value_and_grad(name):
    v = VARIANTS[name]
    b = batch(len(name))
    cfg = JP.PPOConfig(n_prefs=PREFS, **v["cfg"])
    jb = {"obs": None, "action": jnp.asarray(b["action"]), "log_prob": jnp.asarray(b["log_prob"]),
          "value": jnp.asarray(b["old_value"]), "adv": jnp.asarray(b["adv"]),
          "ret": jnp.asarray(b["ret"])}
    if v.get("pref"):
        jb["pref_id"] = jnp.asarray(b["pref_id"])
    if "kl" in v:
        jb["anchor_logits"] = jnp.asarray(b["anchor"])
    params = {"logits": jnp.asarray(b["logits"]), "value": jnp.asarray(b["value"])}
    (jloss, jterms), jgrad = jax.value_and_grad(
        lambda p: JP._ppo_loss(identity, p, cfg, jb, jnp.float32(0.02),
                               jnp.asarray(v.get("kl", 0.0), jnp.float32)), has_aux=True)(params)

    spec = port_spec(b, cfg, v)
    loss, terms, dlogits, dvalue = K9.policy_loss_plain(
        spec, torch.as_tensor(b["logits"]), torch.as_tensor(b["value"]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(terms.numpy(), np.asarray(jterms), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(jgrad["logits"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dvalue.numpy(), np.asarray(jgrad["value"]), rtol=TOL, atol=TOL)
    # the batch exercises both clips
    ratio = np.exp(np.asarray(jax.nn.log_softmax(b["logits"]))[np.arange(B), b["action"]]
                   - b["log_prob"])
    assert ((ratio < 0.8) | (ratio > 1.2)).any() and (np.abs(b["value"] - b["old_value"]) > 0.2).any()

    # through the autograd Function, the same loss and gradients
    logits = torch.as_tensor(b["logits"]).requires_grad_()
    value = torch.as_tensor(b["value"]).requires_grad_()
    floss, fterms = K9.ppo_loss(logits, value, spec)
    (2.0 * floss).backward()
    torch.testing.assert_close(logits.grad, 2.0 * dlogits, rtol=0, atol=0)
    torch.testing.assert_close(value.grad, 2.0 * dvalue, rtol=0, atol=0)
    torch.testing.assert_close(fterms, terms, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["clip_norm", "no_value_clip", "per_pref", "kl_per_pref"])
def test_written_out_gradients_match_autograd(name):
    """Away from the clip boundaries the written-out gradients are
    autograd's of the same plain loss."""
    v = VARIANTS[name]
    b = batch(10 + len(name))
    spec = port_spec(b, JP.PPOConfig(n_prefs=PREFS, **v["cfg"]), v)
    logits = torch.as_tensor(b["logits"]).requires_grad_()
    value = torch.as_tensor(b["value"]).requires_grad_()
    loss, _, dlogits, dvalue = K9.policy_loss_plain(spec, logits, value)
    glogits, gvalue = torch.autograd.grad(loss, (logits, value))
    torch.testing.assert_close(dlogits, glogits, rtol=TOL, atol=1e-7)
    torch.testing.assert_close(dvalue, gvalue, rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("step,ent_coef", [("bc", 0.1), ("dagger", 0.0), ("dagger", 0.3)])
def test_ce_mode_matches_bc_and_dagger_steps(step, ent_coef):
    b = batch(5)
    params = {"logits": jnp.asarray(b["logits"]), "value": jnp.asarray(b["value"])}
    sgd = optax.sgd(1.0)
    if step == "bc":
        new, _, jloss = JB.bc_step(identity, sgd, params, sgd.init(params), None,
                                   jnp.asarray(b["action"]))
    else:
        new, _, jloss = JD._bc_batch_step(identity, sgd, params, sgd.init(params), None,
                                          jnp.asarray(b["action"]), jnp.float32(ent_coef))
    jgrad = b["logits"] - np.asarray(new["logits"])
    spec = K9.LossSpec(action=torch.as_tensor(b["action"]), ent_coef=ent_coef)
    loss, terms, dlogits, dvalue = K9.policy_loss_plain(spec, torch.as_tensor(b["logits"]), None)
    assert dvalue is None
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dlogits.numpy(), jgrad, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(terms[0]) - ent_coef * float(terms[2]), float(jloss),
                               rtol=TOL, atol=TOL)
    logits = torch.as_tensor(b["logits"]).requires_grad_()
    floss, _ = K9.ce_loss(logits, torch.as_tensor(b["action"]), ent_coef)
    floss.backward()
    torch.testing.assert_close(logits.grad, dlogits, rtol=0, atol=0)


@pytest.mark.parametrize("mode, fields, ok", [
    ("ce", (), True), ("ce", ("adv", "ret"), False), ("a2c", ("adv", "ret"), True),
    ("a2c", ("adv",), False), ("a2c", ("adv", "ret", "old_log_prob"), False),
    ("ppo", ("old_log_prob", "old_value", "adv", "ret"), True),
    ("ppo", ("adv", "ret"), False), ("bc", (), False),
])
def test_loss_spec_mode_needs_and_reads_only_its_tensors(mode, fields, ok):
    """A spec's ``mode`` alone picks the loss: a tensor the mode needs and
    lacks, or one it would not read, is refused instead of ignored."""
    b = batch(6)
    t = {"adv": "adv", "ret": "ret", "old_log_prob": "log_prob", "old_value": "old_value"}
    spec = K9.LossSpec(action=torch.as_tensor(b["action"]), ent_coef=0.01, mode=mode,
                       **{f: torch.as_tensor(b[t[f]]) for f in fields})
    call = lambda: K9.policy_loss(spec, torch.as_tensor(b["logits"]), torch.as_tensor(b["value"]))
    if ok:
        assert len(call()) == 4
    else:
        with pytest.raises(ValueError, match="mode"):
            call()
