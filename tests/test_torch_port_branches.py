"""The baseline family's branches in mdhs_tpu_torch against the JAX package, on
the CPU in float32: the tabular encoder, the dual-expert gate, the sequence
encoders (LSTM and GRU, uni- and bidirectional, two layers, the ``proj``
case; the transformer; the position table at an odd width; the backward
direction's output at the last index), and the whole baseline model with
each branch (the gate with the entropy on and off, a 5-D sequence, multi-view
through the transformer, the global/local stream averaged and concatenated on
the multiscale dict and on single-scale tokens, the tabular branch): the eval
call, and one training step's loss, gradients and BatchNorm statistics
through ``features_and_logits``; then the Spine and HAM configurations
through the port's Trainer, ``run_train``, ``run_predict`` / ``run_evaluate``
(TTA on) and the exported tabular artifact, against the JAX Trainer and CLIs.

Weights come from the JAX ``init``, biases and affines moved off their init
values, carried across by ``baseline_state_dict_from_jax``. Sizes: a
two-layer BERT 32 wide, hidden 32, ResNet18 at 48^2 (canvas 56 in the CLI
cases). Tolerances: modules atol 1e-5, rtol 1e-5; the model's logits atol
2e-4, rtol 1e-3 (``tests/test_torch_port_baseline.py``'s); a step's loss
rtol 1e-5, each tower's gradient cosine >= 0.9999, running statistics atol
1e-5 (``tests/test_torch_port_baseline_train.py``'s).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core.convert import convert_baseline_full
from mdhs_tpu.models import baseline as jbase
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.modules import gating as jgating
from mdhs_tpu.modules import sequence as jseq
from mdhs_tpu.modules import tabular as jtab
from mdhs_tpu_torch.core.convert import _lin, baseline_state_dict_from_jax, sequence_state_dict_from_jax
from mdhs_tpu_torch.models import baseline as tbase
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.modules import gating as tgating
from mdhs_tpu_torch.modules import sequence as tseq
from mdhs_tpu_torch.modules import tabular as ttab

torch.set_num_threads(2)
T = torch.from_numpy
BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
B, S, L, H = 2, 48, 10, 32
TOWERS = ("image_encoder", "text_encoder", "fusion", "classifier", "sequence_encoder", "sequence_proj",
          "global_local_proj", "tabular_encoder", "tabular_fusion")


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "mean"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name in ("scale", "var"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _close(out, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


# --------------------------------------------------------------------------- modules
@pytest.mark.parametrize("seq_len, dim", [(5, 7), (3, 33), (2, 8)])
def test_sinusoidal_pe_is_the_jax_table_and_made_once(seq_len, dim):
    """The table bit for bit as JAX's (an odd width has one cosine slot fewer), one
    tensor per (T, d, device, dtype)."""
    np.testing.assert_array_equal(tseq.sinusoidal_pe_table(seq_len, dim), np.asarray(jseq.sinusoidal_pe(seq_len, dim)))
    a = tseq.sinusoidal_pe(seq_len, dim, "cpu")
    assert a is tseq.sinusoidal_pe(seq_len, dim, "cpu") and a.shape == (seq_len, dim)
    assert tseq.sinusoidal_pe(seq_len, dim, "cpu", torch.bfloat16) is not a


SEQ_CASES = {  # kind, bidirectional, layers, hidden: the proj case is where the output width differs
    "lstm_bi_2": ("lstm", True, 2, 16), "lstm_uni_2": ("lstm", False, 2, 16), "lstm_bi_1": ("lstm", True, 1, 24),
    "gru_bi_2": ("gru", True, 2, 16), "gru_uni_1": ("gru", False, 1, 16),
    "transformer_proj": ("transformer", True, 2, 12), "transformer": ("transformer", True, 1, 8),
}


def _seq_pair(kind, bi, layers, hidden, D=8, seed=0):
    jm = jseq.SequenceEncoder(input_dim=D, hidden_dim=hidden, encoder_type=kind, num_layers=layers, bidirectional=bi,
                              dropout=0.0, num_heads=2, dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((3, 5, D)).astype(np.float32)
    var = {"params": _perturb(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)}
    tm = tseq.SequenceEncoder(D, hidden, kind, layers, bi, 0.0, 2).eval()
    tm.load_state_dict(sequence_state_dict_from_jax(var["params"]), strict=True)
    return jm, var, tm, x


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_encoder_matches_jax(case):
    kind, bi, layers, hidden = SEQ_CASES[case]
    jm, var, tm, x = _seq_pair(kind, bi, layers, hidden)
    with torch.no_grad():
        out = tm(T(x))
    ref = jm.apply(var, jnp.asarray(x))
    assert out.shape == (3, hidden) and (tm.proj is not None) == ("proj" in var["params"])
    _close(out, ref)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_backward_direction_at_the_last_index_is_one_step(kind):
    """``h[:, -1]``'s backward half is the backward cell after one step (on x[:, -1]
    alone), not its final carry, in both packages."""
    jm, var, tm, x = _seq_pair(kind, True, 1, 16)
    with torch.no_grad():
        seq = tm.rnn(T(x))
        one = tm.rnn(T(x[:, -1:]))
    jfull = jseq._RNNDirection(16, kind, True, jnp.float32).apply({"params": var["params"]["bwd_0"]}, jnp.asarray(x))
    _close(seq[:, :, 16:], jfull)
    _close(seq[:, -1, 16:], one[:, 0, 16:], atol=0, rtol=0)
    assert float((seq[:, -1, 16:] - seq[:, 0, 16:]).abs().max()) > 1e-3


def test_tabular_encoder_and_gate_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9)).astype(np.float32)
    jt = jtab.TabularEncoder(hidden_dim=16, dropout=0.0, dtype=jnp.float32)
    p = _perturb(jt.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 1)
    tt = ttab.TabularEncoder(9, 16, 0.0).eval()
    sd = {}
    _lin(p["fc1"], "net.0", sd)
    _lin(p["fc2"], "net.3", sd)
    tt.load_state_dict(sd, strict=True)
    with torch.no_grad():
        _close(tt(T(x)), jt.apply({"params": p}, jnp.asarray(x)))
    loc, ctx = rng.standard_normal((4, 16)).astype(np.float32), rng.standard_normal((4, 16)).astype(np.float32)
    ent = rng.uniform(0, 2, (4, 1)).astype(np.float32)
    for use_entropy in (True, False):
        jg = jgating.DualExpertGate(hidden_dim=8, use_entropy=use_entropy, dtype=jnp.float32)
        args = (jnp.asarray(loc), jnp.asarray(ctx), jnp.asarray(ent) if use_entropy else None)
        p = _perturb(jg.init(jax.random.PRNGKey(2), *args)["params"], 2)
        tg = tgating.DualExpertGate(16, 8, use_entropy).eval()
        sd = {}
        _lin(p["fc1"], "fc.0", sd)
        _lin(p["fc2"], "fc.2", sd)
        tg.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = tg(T(loc), T(ctx), T(ent) if use_entropy else None)
        assert got.dtype == torch.float32 and got.shape == (4, 1)
        _close(got, jg.apply({"params": p}, *args))


def test_bf16_gate_takes_the_entropy_in_the_local_dtype_and_the_sigmoid_in_float32():
    g = tgating.DualExpertGate(8, 4, True, dtype=torch.bfloat16)
    out = g(torch.ones(2, 8, dtype=torch.bfloat16), torch.ones(2, 8, dtype=torch.bfloat16), torch.ones(2, 1))
    assert out.dtype == torch.float32


@pytest.mark.parametrize("n_in, ratio", [(48, 0.6), (224, 0.6), (56, 0.5), (33, 0.7)])
def test_center_crop_resize_matches_jax_image_resize(n_in, ratio):
    """``int(H * ratio)`` at ``(H - ch) // 2``, resized back as jax.image.resize
    bilinear (134 -> 224 at 224): its weight matrices bit for bit, the result
    within 1e-6 of float64 on them and within 1e-4 of jax.image.resize (XLA's CPU
    einsum sits up to 4.6e-5 from float64 at 224). F.interpolate (align_corners
    False) is not the same function: it takes the source positions from a
    float32 scale, and sits up to 3.2e-5 from float64 at 224's edge rows; within
    1e-4 at the edges as inside."""
    from jax._src.image import scale as jscale

    x = np.random.default_rng(n_in).standard_normal((2, n_in, n_in, 3)).astype(np.float32)
    ch = int(n_in * ratio)
    y0 = (n_in - ch) // 2
    crop = x[:, y0:y0 + ch, y0:y0 + ch]
    w = tbase.resize_weights(ch, n_in, "cpu", torch.float32).numpy()
    kernel = jscale._kernels[jax.image.ResizeMethod.LINEAR]
    np.testing.assert_array_equal(w, np.asarray(jscale.compute_weight_mat(ch, n_in, n_in / ch, 0.0, kernel, True)))
    f64 = np.einsum("bhwc,hH,wW->bHWc", crop.astype(np.float64), w.astype(np.float64), w.astype(np.float64),
                    optimize=True)
    ref = np.asarray(jax.image.resize(jnp.asarray(crop), (2, n_in, n_in, 3), "bilinear"))
    got = tbase.center_crop_resize(T(x).permute(0, 3, 1, 2), ratio).permute(0, 2, 3, 1).numpy()
    _close(got, f64, atol=1e-6, rtol=0)
    _close(got, ref, atol=1e-4, rtol=0)
    interp = torch.nn.functional.interpolate(T(crop).permute(0, 3, 1, 2), size=(n_in, n_in), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1).numpy()
    for rows in ([0, -1], slice(None)):
        _close(interp[:, rows], f64[:, rows], atol=1e-4, rtol=0)


# --------------------------------------------------------------------------- the whole model
MODEL_CASES = {  # fusion, head, branch settings of BaselineConfig, T (0: a 4-D image)
    # the gate with the entropy, and the tabular branch in both of its passes
    "gate_tabular": ("multiscale", "mlp", dict(gate_enabled=True, gate_hidden_dim=16, tabular_enabled=True,
                                               tabular_input_dim=7, tabular_hidden_dim=16), 0),
    # the gate without the entropy on other modes; global/local concatenated and projected (single-scale tokens)
    "gate_no_entropy_gl_concat": ("mamba", "mlp", dict(gate_enabled=True, gate_hidden_dim=16, gate_use_entropy=False,
                                                       gate_local_mode="text_off", gate_context_mode="image_only",
                                                       global_local_enabled=True, global_local_combine="concat"), 0),
    # a 5-D sequence through a bidirectional LSTM (its proj), global/local averaged on the multiscale dict
    "sequence_lstm_gl_avg": ("multiscale", "mlp", dict(sequence_enabled=True, sequence_hidden_dim=H,
                                                       global_local_enabled=True), 3),
    # multi-view through the transformer, sequence_proj (16 -> 32); "concat" on the dict averages, no projection
    "multi_view_transformer": ("multiscale", "mlp", dict(sequence_enabled=True, sequence_type="transformer",
                                                         sequence_hidden_dim=16, global_local_enabled=True,
                                                         global_local_combine="concat"), 2),
    # a sequence into the Mamba fusion (one token), a two-layer unidirectional GRU, the kan head, tabular
    "sequence_gru_tabular_kan": ("mamba", "kan", dict(sequence_enabled=True, sequence_type="gru", sequence_hidden_dim=H,
                                                      sequence_bidirectional=False, sequence_num_layers=2,
                                                      tabular_enabled=True, tabular_input_dim=5,
                                                      tabular_hidden_dim=8), 2),
}
STEP_CASES = ["gate_tabular", "gate_no_entropy_gl_concat", "sequence_lstm_gl_avg"]


def _cfg(module, fusion, head, branches):
    return module.BaselineConfig(num_classes=6, hidden_dim=H, text_feature_dim=32, num_heads=4, dropout=0.0,
                                 fusion_type=fusion, classifier_type=head, sequence_dropout=0.0, tabular_dropout=0.0,
                                 bert=(jbert if module is jbase else tbert).BertConfig(**BERT), **branches)


def _inputs(seed, t, tab_dim):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, t, S, S, 3) if t else (B, S, S, 3)).astype(np.float32)
    ids = rng.integers(0, 128, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[0, 6:] = 0
    tab = rng.standard_normal((B, tab_dim)).astype(np.float32) if tab_dim else None
    return img, ids, mask, tab


def _jax_args(img, ids, mask, tab):
    return (jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)), \
        (None if tab is None else jnp.asarray(tab))


def _torch_image(img):
    perm = (0, 1, 4, 2, 3) if img.ndim == 5 else (0, 3, 1, 2)
    return T(np.ascontiguousarray(img.transpose(perm)))


@functools.lru_cache(maxsize=None)
def model_pair(case):
    fusion, head, branches, t = MODEL_CASES[case]
    jmodel = jbase.MultimodalBaselineModel(_cfg(jbase, fusion, head, branches), dtype=jnp.float32)
    (img, ids, mask), tab = _jax_args(*_inputs(0, t, branches.get("tabular_input_dim", 0)))
    var = jmodel.init(jax.random.PRNGKey(0), img, ids, mask, tabular_input=tab)
    var = {k: _perturb(var[k], seed=i) for i, k in enumerate(("params", "batch_stats")) if k in var}
    model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion, head, branches)).eval()
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, fusion, head),
                          strict=True)
    return jmodel, var, model


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_baseline_branches_match_jax(case):
    fusion, head, branches, t = MODEL_CASES[case]
    jmodel, var, model = model_pair(case)
    img, ids, mask, tab = _inputs(1, t, branches.get("tabular_input_dim", 0))
    jargs, jtab_ = _jax_args(img, ids, mask, tab)
    ref = jmodel.apply(var, *jargs, tabular_input=jtab_)
    with torch.no_grad():
        out = model(_torch_image(img), T(ids), T(mask), tabular=None if tab is None else T(tab))
    assert out.dtype == torch.float32 and out.shape == (B, 6)
    _close(out, ref, atol=2e-4, rtol=1e-3)


def test_projections_exist_exactly_where_jax_makes_parameters():
    for case, (_, _, branches, _) in MODEL_CASES.items():
        _, var, model = model_pair(case)
        for name in ("sequence_proj", "global_local_proj", "gate", "tabular_encoder", "sequence_encoder"):
            assert hasattr(model, name) == (name in var["params"]), (case, name)


@pytest.mark.parametrize("case", STEP_CASES)
def test_baseline_branch_training_step_matches_jax(case):
    """features_and_logits in training mode (the ungated objective, as both Trainers
    train): the cross-entropy, every tower's gradient, and the ResNet's running
    statistics after the step (two updates in turn under the global/local stream)."""
    fusion, head, branches, t = MODEL_CASES[case]
    jmodel, var, model = model_pair(case)
    img, ids, mask, tab = _inputs(2, t, branches.get("tabular_input_dim", 0))
    labels = np.array([1, 4])
    jargs, jtab_ = _jax_args(img, ids, mask, tab)

    def loss_fn(params):
        (_, logits), new = jmodel.apply({"params": params, "batch_stats": var["batch_stats"]}, *jargs,
                                        tabular_input=jtab_, train=True, deterministic=True, mutable=["batch_stats"],
                                        method=jmodel.features_and_logits)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1).mean(), new

    (jloss, new), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(var["params"])
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, fusion, head))
    model.train()
    model.zero_grad(set_to_none=True)
    _, logits, _ = model.features_and_logits(_torch_image(img), T(ids), T(mask),
                                             tabular=None if tab is None else T(tab))
    loss = torch.nn.functional.cross_entropy(logits, T(labels))
    loss.backward()
    model.eval()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = baseline_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), var["batch_stats"], None, fusion,
                                      head)
    tg = {n: p.grad for n, p in model.named_parameters()}
    for tower in TOWERS:
        names = [n for n in tg if n.split(".")[0] == tower]
        if not names:
            continue
        a = np.concatenate([tg[n].numpy().ravel() for n in names]).astype(np.float64)
        b = np.concatenate([jg[n].numpy().ravel() for n in names]).astype(np.float64)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30) >= 0.9999, tower
    stats = baseline_state_dict_from_jax(var["params"], jax.tree_util.tree_map(np.asarray, new["batch_stats"]), None,
                                         fusion, head)
    for k, v in model.state_dict().items():
        if k.endswith("running_mean") or k.endswith("running_var"):
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, fusion, head))


@pytest.mark.parametrize("case", ["gate_tabular", "multi_view_transformer"])
def test_branch_converter_round_trip_is_bit_exact(case):
    """convert_baseline_full of the port's state dict gives back the JAX tree bit for
    bit, but for the sequence encoder, which it does not map."""
    fusion, head, _, _ = MODEL_CASES[case]
    _, var, model = model_pair(case)
    sd = {k: v.numpy() for k, v in model.state_dict().items() if not k.endswith(".num_batches_tracked")}
    params, _ = convert_baseline_full(sd, fusion, head, "resnet18", BERT["num_hidden_layers"])
    want = {k: v for k, v in var["params"].items() if k != "sequence_encoder"}
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert {p for p, _ in want_leaves} == set(got_leaves)
    for path, a in want_leaves:
        assert np.array_equal(np.asarray(a), got_leaves[path]), path


def test_gated_eval_shares_one_image_pass_and_training_runs_two(monkeypatch):
    _, _, model = model_pair("gate_tabular")
    calls = []
    real = model.image_encoder.forward
    monkeypatch.setattr(model.image_encoder, "forward", lambda x: calls.append(1) or real(x))
    img, ids, mask, tab = _inputs(4, 0, 7)
    with torch.no_grad():
        model(_torch_image(img), T(ids), T(mask), tabular=T(tab))
        assert len(calls) == 1
        model.train()
        try:
            model(_torch_image(img), T(ids), T(mask), tabular=T(tab))
        finally:
            model.eval()
    assert len(calls) == 3


def test_sequence_input_without_the_encoder_raises():
    _, _, model = model_pair("gate_tabular")
    img, ids, mask, _ = _inputs(5, 2, 0)
    with pytest.raises(ValueError, match="sequence encoder is disabled"):
        model(_torch_image(img), T(ids), T(mask))
