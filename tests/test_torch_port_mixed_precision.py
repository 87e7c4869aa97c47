"""The bf16 training step against float32, in the port and in the JAX package.

One MIBF-Net training-mode forward and backward (MP-Loss, dropout 0) at the
sizes of tests/test_train_step_parity.py::test_mibf_train_step_parity (one
BERT layer 768 wide, intermediate 128, vocabulary 128, B = 4, 64^2 images),
on the port's seeded init (``init_parameters``, every BatchNorm scale 1) and
on the same weights with each bottleneck's last BatchNorm scale at 0.1, as
chip_smoke.py's train phase damps them. The weights are carried into the JAX
model with ``convert_mibf_full``. In each package the bf16 step (the port's
bf16 working module; the JAX model with ``dtype=bfloat16``) is held against
its float32 step by the cosine of each tower's gradients.

This is the witness that a low image-tower cosine on the seeded init belongs
to the model and not to the port's mixed precision: the JAX package's own
bf16 step reads it too (below 0.5), and with the residual branches damped
both read above 0.95. The port's cosine may fall below JAX's by at most 0.02
in any tower (the two round to bf16 in another order; measured, the port's
is the higher in every tower). Run as a script, it prints the cosines.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core.convert import convert_mibf_full
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import mibf as jmibf
from mdhs_tpu.train import losses as jlosses
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import mibf as tmibf
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer
from test_torch_port_train import MIBF_BERT, _flat_cos

torch.set_num_threads(2)

B, S, L, LABELS = 4, 64, 12, 7
TOWERS = ("image_encoder", "text_encoder", "textbased_cross_attention", "imagbased_cross_attention")
HEADS = ("fc", "fc_image_hidden", "fc_image_out", "fc_text_hidden", "fc_text_out")
RESIDUAL_BN_SCALE = 0.1  # chip_smoke.py's damping of each bottleneck's bn3
MARGIN = 0.02


def _inputs():
    rng = np.random.default_rng(0)
    mask = np.ones((B, L), np.int64)
    mask[1, L // 2:] = 0
    return (rng.random((B, S, S, 3), dtype=np.float32), rng.integers(0, 128, (B, L)).astype(np.int64), mask,
            rng.integers(0, LABELS, B).astype(np.int64))


def _tower_cosines(a, b) -> dict:
    out = {t: _flat_cos(a[t], b[t]) for t in TOWERS}
    out["heads"] = _flat_cos([a[h] for h in HEADS], [b[h] for h in HEADS])
    return out


def _jax_grads(model_sd, img, ids, mask, labels) -> dict:
    params, stats = convert_mibf_full(model_sd, num_bert_layers=1)
    grads = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        model = jmibf.MIBFNet(num_labels=LABELS, bert=jbert.BertConfig(**MIBF_BERT), dtype=dt)

        def loss_fn(p, model=model, dt=dt):
            out, _ = model.apply({"params": p, "batch_stats": stats}, jnp.asarray(img, dt), jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(mask, jnp.int32), train=True, deterministic=True,
                                 mutable=["batch_stats"])
            return jlosses.mibf_loss(out, jnp.asarray(labels, jnp.int32), "KL_loss")

        grads[name] = jax.jit(jax.grad(loss_fn))(params)
    return grads


def _port_grads(model, img, ids, mask, labels) -> dict:
    grads = {}
    for prec in ("f32", "bf16"):
        preset = dataclasses.replace(MIBF_HAM_TRAIN, bert=tbert.BertConfig(**MIBF_BERT), batch_size=B, seq_len=L,
                                     canvas=S, image_size=S, precision=prec)
        trainer = Trainer(preset, model=copy.deepcopy(model), device="cpu")
        dev = {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask),
               "label": torch.from_numpy(labels)}
        trainer.forward_backward(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().to(trainer.dtype), dev)
        sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float().numpy()
              for k, p in trainer.model.named_parameters()}
        sd.update({k: np.zeros(b.shape, np.float32) for k, b in trainer.model.named_buffers()
                   if not k.endswith("num_batches_tracked")})
        grads[prec] = convert_mibf_full(sd, num_bert_layers=1)[0]
    return grads


def bf16_vs_f32(damped: bool) -> dict:
    """Per-tower gradient cosines of the bf16 step against the float32 one, in each package."""
    model = init_parameters(tmibf.MIBFNet(LABELS, tbert.BertConfig(**MIBF_BERT)), torch.Generator().manual_seed(3))
    if damped:
        with torch.no_grad():
            for name, m in model.image_encoder.named_modules():
                if name.endswith(".bn3"):
                    m.weight.fill_(RESIDUAL_BN_SCALE)
    inputs = _inputs()
    j = _jax_grads({k: v.detach().numpy() for k, v in model.state_dict().items()}, *inputs)
    t = _port_grads(model, *inputs)
    return {"jax": _tower_cosines(j["f32"], j["bf16"]), "port": _tower_cosines(t["f32"], t["bf16"])}


@pytest.mark.parametrize("damped", [False, True], ids=["seeded_init", "damped"])
def test_port_bf16_step_departs_from_float32_as_the_jax_package_does(damped):
    cos = bf16_vs_f32(damped)
    for tower, c in cos["port"].items():
        assert c >= cos["jax"][tower] - MARGIN, (tower, cos)
    if damped:
        assert min(cos["jax"]["image_encoder"], cos["port"]["image_encoder"]) >= 0.95, cos
    else:
        assert max(cos["jax"]["image_encoder"], cos["port"]["image_encoder"]) < 0.5, cos


if __name__ == "__main__":
    print(json.dumps({which: bf16_vs_f32(which == "damped") for which in ("seeded_init", "damped")}))
