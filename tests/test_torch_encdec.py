"""whisper's encoder-decoder and internvl2's patch prefix in the port against
the JAX package's, on the CPU.

Smoke configs (whisper-medium: 2 encoder and 2 decoder layers over 30 stub
frames; internvl2-26b: 3 layers, GQA 4/2, 8 patch embeddings before the
prompt). The weights come from the JAX init through
``convert.lm_params_from_numpy``; token ids, frames and patch embeddings are
made with numpy from a seed and given to both packages.

Tolerances, float32, as the dense family's (``tests/test_torch_lm.py``):
both packages compute every product in float32 but sum in other orders, so
logits (magnitudes up to ~45) are held to ``atol=2e-4, rtol=1e-5``, the
encoder's output and cache entries to ``atol=rtol=2e-5``; greedy ids must be
equal. bfloat16: logits within ``2**-4 · max|logit|`` (each package rounds
activations to bfloat16 at other points). ``input_specs``: shapes and dtype
names equal. The parameter tree round trip is bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.configs import shape_is_applicable  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import input_specs as j_input_specs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.convert import _layer_places, lm_params_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.models import Model, input_specs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

ARCHS = ["whisper-medium", "internvl2-26b"]
LOGIT_TOL = dict(atol=2e-4, rtol=1e-5)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)
PROMPT = 12


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(j_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


_JAX_PARAMS = {}


def _models(arch, **kw):
    """(jax cfg, jax params, port cfg, port params) with one set of weights."""
    jcfg, cfg = _cfgs(arch, **kw)
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = jax.jit(JModel(_cfgs(arch)[0]).init)(jax.random.PRNGKey(0))
    jp = _JAX_PARAMS[arch]
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _inputs(cfg, b=2, s=PROMPT, seed=1):
    """Tokens and the stub inputs the config takes, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.vision is not None:
        out["patch_embeds"] = rng.standard_normal((b, cfg.vision.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal((b, cfg.encdec.encoder_frames, cfg.d_model)).astype(np.float32)
    return out


def _split(inputs, to=np.asarray):
    extra = {k: to(v) for k, v in inputs.items() if k != "tokens"}
    return to(inputs["tokens"]), extra


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _prefix(cfg):
    return cfg.vision.num_patches if cfg.vision is not None else 0


def test_both_families_build_with_the_reference_layout():
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        params = ttr.init_params(cfg, 0, device="cpu")
        assert all(hasattr(b, "cross") == cfg.is_enc_dec for b in params.layers)
        assert hasattr(params, "encoder") == cfg.is_enc_dec
        if cfg.is_enc_dec:
            assert len(params.encoder.blocks) == cfg.encdec.num_encoder_layers
            assert not any(hasattr(b, "cross") for b in params.encoder.blocks)
            assert all(float(b.lnx.scale.abs().sum()) == 0 for b in params.layers)


@pytest.mark.parametrize("arch", ARCHS + ["gemma-2b", "deepseek-moe-16b", "recurrentgemma-9b"])
def test_parameter_tree_round_trip_is_bitwise(arch):
    jcfg, jp, cfg, params = _models(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = lm_params_to_numpy(cfg, params)
    want, wdef = jax.tree_util.tree_flatten(tree)
    got, gdef = jax.tree_util.tree_flatten(back)
    assert gdef == wdef
    assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))


def test_encoder_matches_jax():
    jcfg, jp, cfg, params = _models("whisper-medium")
    frames = _inputs(cfg)["frames"]
    want = jax.jit(lambda p, f: jtr._run_encoder(p, f, jcfg))(jp, frames)
    got = ttr._run_encoder(params, torch.from_numpy(frames), cfg)
    assert got.shape == (2, cfg.encdec.encoder_frames, cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), **CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jp, cfg, params = _models(arch)
    toks, extra = _split(_inputs(cfg))
    jl, _ = jax.jit(lambda p, t, e: jtr.forward(jcfg, p, t, **e))(jp, toks, extra)
    tl, aux = ttr.forward(cfg, params, torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert tl.shape == (2, _prefix(cfg) + PROMPT, cfg.vocab_padded) and aux == {}
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
    # the facade passes the stub inputs through
    mtl, _ = Model(cfg, device="cpu").apply(params, torch.from_numpy(toks),
                                            **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert torch.equal(mtl, tl)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch):
    jcfg, jp, cfg, params = _models(arch, dtype="bfloat16")
    toks, extra = _split(_inputs(cfg))
    jl, _ = jax.jit(lambda p, t, e: jtr.forward(jcfg, p, t, **e))(jp, toks, extra)
    tl, _ = ttr.forward(cfg, params, torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert tl.dtype == torch.bfloat16
    top = float(np.abs(_f32(jl)).max())
    assert float(np.abs(_f32(tl) - _f32(jl)).max()) <= 2**-4 * top


def _jax_cache_layers(jcfg, cache):
    _, nb, pat, _ = jtr._plan(jcfg)
    return [jax.tree.map(lambda a: a[b], cache["blocks"][pos]) for b in range(nb) for pos in range(len(pat))]


def _check_caches(tc, jc, jcfg):
    jl = _jax_cache_layers(jcfg, jc)
    assert len(tc) == len(jl) == jcfg.num_layers
    for i, (t, j) in enumerate(zip(tc, jl)):
        flat_t = {f"{a}.{b}": v for a, d in t.items() for b, v in d.items()}
        flat_j = {f"{a}.{b}": v for a, d in j.items() for b, v in d.items()}
        assert flat_t.keys() == flat_j.keys(), i
        for name, v in flat_t.items():
            assert tuple(v.shape) == flat_j[name].shape, (i, name)
            np.testing.assert_allclose(_f32(v), _f32(flat_j[name]), **CACHE_TOL, err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("attn_impl", ["ref", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, attn_impl):
    """prefill's last logits and cache (whisper's cross_kv too), then 5 decode
    steps on JAX's greedy tokens; ``"pallas"`` runs B3's plain version here."""
    jcfg, jp, cfg, params = _models(arch, attn_impl=attn_impl)
    toks, extra = _split(_inputs(cfg))
    max_len = _prefix(cfg) + PROMPT + 6
    jl, jc = jax.jit(lambda p, t, e: jtr.prefill(jcfg, p, t, max_len, **e))(jp, toks, extra)
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    tl, tc = Model(cfg, device="cpu").prefill(params, torch.from_numpy(toks), max_len, **textra)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
    _check_caches(tc, jc, jcfg)
    decode = jax.jit(lambda c, tok, pos: jtr.decode_step(jcfg, jp, c, tok, pos))
    tok = np.argmax(_f32(jl)[:, 0, : cfg.vocab_size], -1).astype(np.int32)[:, None]
    for t in range(5):
        pos = _prefix(cfg) + PROMPT + t
        jl, jc = decode(jc, tok, np.int32(pos))
        tl, tc = ttr.decode_step(cfg, params, tc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
        tok = np.argmax(_f32(jl)[:, 0, : cfg.vocab_size], -1).astype(np.int32)[:, None]
        assert np.array_equal(tok, tl[:, 0, : cfg.vocab_size].argmax(-1, keepdim=True).numpy())
    _check_caches(tc, jc, jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_gives_forward(arch):
    _, _, cfg, params = _models(arch)
    toks, extra = _split(_inputs(cfg, b=1), to=torch.from_numpy)
    want, _ = ttr.forward(cfg, params, toks, **extra)
    cut = 8
    lg, cache = ttr.prefill(cfg, params, toks[:, :cut], _prefix(cfg) + PROMPT, **extra)
    steps = [lg]
    for p in range(cut, PROMPT - 1):
        lg, cache = ttr.decode_step(cfg, params, cache, toks[:, p:p + 1], _prefix(cfg) + p)
        steps.append(lg)
    got = torch.cat(steps, 1)
    np.testing.assert_allclose(_f32(got), _f32(want[:, _prefix(cfg) + cut - 1:-1]), **LOGIT_TOL)


@pytest.mark.parametrize("cross_len", [None, 7])
def test_cross_decode_matches_jax(cross_len):
    jcfg, jp, cfg, params = _models("whisper-medium")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shape = (2, cfg.encdec.encoder_frames, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    want, jc = jattn.attn_decode(jblk["cross"], jnp.asarray(x), {"k": k, "v": v}, jcfg, 5,
                                 cross=True, cross_len=cross_len)
    cache = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    got, tc = tattn.attn_decode(params.layers[0].cross, torch.from_numpy(x), cache, cfg, 5,
                                cross=True, cross_len=cross_len)
    np.testing.assert_allclose(_f32(got), _f32(want), **CACHE_TOL)
    assert tc is cache and np.array_equal(tc["k"].numpy(), k)  # left as it is


def test_prefill_refuses_what_the_reference_cannot_run():
    _, _, cfg, params = _models("whisper-medium")
    with pytest.raises(ValueError, match="needs frames"):
        ttr.prefill(cfg, params, torch.zeros((1, 4), dtype=torch.int32), 8)
    _, _, vcfg, vparams = _models("internvl2-26b")
    toks, extra = _split(_inputs(vcfg, b=1), to=torch.from_numpy)
    with pytest.raises(ValueError, match="patches included"):
        ttr.prefill(vcfg, vparams, toks, PROMPT + 2, **extra)


def _cases():
    for arch in j_list_archs():
        for shape in J_SHAPES:
            if shape_is_applicable(arch, shape):
                yield arch, shape


def _spec_leaves(tree):
    """(path, shape, dtype name) of every leaf of a spec tree."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((jax.tree_util.keystr(path), tuple(leaf.shape), str(leaf.dtype)))
    return out


@pytest.mark.parametrize("arch,shape", list(_cases()))
def test_input_specs_match_jax(arch, shape):
    want = j_input_specs(j_get_config(arch), J_SHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert got.keys() == want.keys()
    for k, v in got.items():
        if k == "cache":
            continue
        assert v.is_meta and tuple(v.shape) == want[k].shape and str(v.dtype)[6:] == str(want[k].dtype), k
    if "cache" in got:
        jl = _spec_leaves(want["cache"])
        seen = 0
        for i, place in enumerate(_layer_places(get_config(arch))):
            prefix = f"['{place[0]}'][{place[1]}]"
            ref = [(s, d) for p, s, d in jl if p.startswith(prefix)]
            stack = () if place[0] != "blocks" else (ref[0][0][0],)  # the scanned layers' axis
            seen += len(ref) if place[0] != "blocks" or place[2] == 0 else 0
            leaves = [v2 for _, d in sorted(got["cache"][i].items()) for _, v2 in sorted(d.items())]
            assert len(leaves) == len(ref), (arch, i)
            for t, (shp, d) in zip(leaves, ref):
                assert t.is_meta and (*stack, *t.shape) == shp and str(t.dtype)[6:] == d, (arch, i)
        assert seen == len(jl)
