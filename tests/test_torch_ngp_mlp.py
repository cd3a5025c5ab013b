"""The Instant-NGP MLP kernel's plain version, wrapper and route
(``kernels/ngp_mlp.py``; the kernel itself is held on the card in
``test_torch_cuda.py``).

The plain version is the model's own f32 operations after the encoding, so
on the CPU it equals ``InstantNGPModel.forward`` bit for bit.  The route
takes the kernel only for an f32 forward on the card with autograd off, not
``spatial_only``, at the kernel's widths: here the card is faked
(``ngp_mlp.on_card``) and the launch replaced by a recorder, so every other
case is seen to run the model's own layers.
"""

import pytest
import torch

from learn_nerf_tpu_torch.kernels import ngp_mlp as km
from learn_nerf_tpu_torch.models import InstantNGPModel

BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))


def ngp(levels=16, seed=0, **kwargs):
    """A small-table NGP model with tables U(-1, 1) and biases U(-0.1, 0.1),
    so every layer's inputs are of unit scale."""
    torch.manual_seed(seed)
    model = InstantNGPModel([1024] * levels, [4 + i for i in range(levels)], **BBOX, **kwargs)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("encoding."):
                p.uniform_(-1.0, 1.0)
            elif p.ndim == 1:
                p.uniform_(-0.1, 0.1)
    return model


def rays(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, generator=g) * 1.8 - 0.9
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    return x, d


@pytest.mark.parametrize("rows", [1, 33, 8193])
@pytest.mark.parametrize("levels", [16, 6])
def test_plain_version_equals_the_model_forward(levels, rows):
    model = ngp(levels)
    x, d = rays(rows, seed=rows)
    with torch.inference_mode():
        want_density, want_rgb, aux = model(x, d)
        enc = model.encoding(x)
        assert enc.shape == (rows, 2 * levels)
        density, rgb = km.ngp_mlp_reference(model.dense_layers(), enc, d)
    assert aux == {}
    assert torch.equal(density, want_density) and torch.equal(rgb, want_rgb)


def test_wrapper_keeps_the_leading_dims():
    model = ngp(6)
    x, d = rays(40)
    with torch.inference_mode():
        enc = model.encoding(x)
        flat = km.ngp_mlp(model.dense_layers(), enc, d)
        shaped = km.ngp_mlp(model.dense_layers(), enc.reshape(8, 5, 12), d.reshape(8, 5, 3))
    assert shaped[0].shape == (8, 5, 1) and shaped[1].shape == (8, 5, 3)
    assert torch.equal(shaped[0].reshape(40, 1), flat[0]) and torch.equal(shaped[1].reshape(40, 3), flat[1])


@pytest.fixture
def faked_card(monkeypatch):
    """Every tensor reads as on the card; the launch records its operands
    and returns the plain version's result."""
    calls = []

    def launch(layers, enc, d):
        calls.append((enc.shape, d.shape))
        return km.ngp_mlp_reference(layers, enc, d)

    monkeypatch.setattr(km, "on_card", lambda t: True)
    monkeypatch.setattr(km, "_cuda_launcher", launch)
    return calls


# (model options, forward options, grad mode, whether the kernel computes it)
ROUTES = {
    "frame (inference mode)": ({}, {}, "inference", True),
    "no_grad": ({}, {}, "no_grad", True),
    "coarse NGP (6 levels, E = 12)": (dict(levels=6), {}, "inference", True),
    "grad recording (training)": ({}, {}, "grad", False),
    "bf16": (dict(compute_dtype="bfloat16"), {}, "inference", False),
    "spatial_only (the bake)": ({}, dict(spatial_only=True), "inference", False),
    "hidden 32": (dict(hidden_dim=32), {}, "inference", False),
    "density_dim 8": (dict(density_dim=8), {}, "inference", False),
    "2 direction frequencies": (dict(d_freqs=2), {}, "inference", False),
    "2 density layers": (dict(density_layers=2), {}, "inference", False),
    "1 colour layer": (dict(color_layers=1), {}, "inference", False),
    "8 levels (E = 16)": (dict(levels=8), {}, "inference", False),
    "F = 4 (E = 64)": (dict(table_feature_dim=4), {}, "inference", False),
}


def grad_mode(mode):
    return {"inference": torch.inference_mode(), "no_grad": torch.no_grad(), "grad": torch.enable_grad()}[mode]


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_takes_the_kernel_only_where_it_engages(faked_card, monkeypatch, case):
    model_opts, call_opts, mode, engaged = ROUTES[case]
    model = ngp(**model_opts)
    x, d = rays(50)
    with grad_mode(mode):
        got = model(x, d, **call_opts)
    assert len(faked_card) == int(engaged)
    if engaged:
        assert faked_card[0] == ((50, len(model.encoding.grid_sizes) * 2), (50, 3))
        monkeypatch.setattr(km, "on_card", lambda t: False)  # the model's own layers
        with torch.inference_mode():
            want = model(x, d)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == {}


def test_route_stays_off_the_cpu():
    model = ngp()
    x, d = rays(20)
    plain = km.counter.plain_calls
    with torch.inference_mode():
        model(x, d)
    # The CPU runs the model's own layers, not the kernel module's plain version.
    assert km.counter.plain_calls == plain


def test_counter_counts(faked_card, monkeypatch):
    model = ngp(6)
    x, d = rays(20)
    with torch.inference_mode():
        enc = model.encoding(x)
        launches, plain = km.counter.launches, km.counter.plain_calls
        model(x, d)  # the faked launch: neither count moves here
        assert km.counter.plain_calls == plain and len(faked_card) == 1
        monkeypatch.setattr(km, "on_card", lambda t: False)
        km.ngp_mlp(model.dense_layers(), enc, d)
        km.ngp_mlp(model.dense_layers(), enc, d)
    assert km.counter.plain_calls == plain + 2 and km.counter.launches == launches


def refusal_case(name):
    model = ngp(6)
    layers = model.dense_layers()
    x, d = rays(8)
    with torch.no_grad():
        enc = model.encoding(x)
    if name == "the CPU":
        return layers, enc, d, "CUDA"
    if name == "f64 encoding":
        return layers, enc.double(), d, "float32"
    if name == "f64 layers":
        return [torch.nn.Linear(l.in_features, l.out_features).double() for l in layers], enc, d, "float32"
    if name == "strided encoding":
        return layers, torch.cat([enc, enc], dim=1)[:, ::2], d, "contiguous"
    if name == "strided directions":
        return layers, enc, d.t().contiguous().t(), "contiguous"
    if name == "E = 16":
        return ngp(8).dense_layers(), torch.zeros(8, 16), d, "E in"
    if name == "rows differ":
        return layers, enc, d[:7], "want enc"
    raise ValueError(name)


@pytest.mark.parametrize("name", ["the CPU", "f64 encoding", "f64 layers", "strided encoding", "strided directions",
                                  "E = 16", "rows differ"])
def test_launch_refuses_what_the_kernel_cannot_take(name):
    layers, enc, d, message = refusal_case(name)
    launches = km.counter.launches
    with pytest.raises(ValueError, match=message):
        km.launch_ngp_mlp(layers, enc, d)
    assert km.counter.launches == launches


def test_kernel_name_counts_as_ngp_mlp_alone():
    """profile_render (and chip_smoke's kernel line) count the kernel as
    ngp_mlp; the benchmark's frozen list counts it as no other kernel."""
    from learn_nerf_tpu_torch.scripts import profile_render
    from nerfbench import trace

    for name in ("void nerf::ngp::ngp_mlp_kernel<32>(float const*, float const*, long long, nerf::ngp::Params, "
                 "float*, float*)", "nerf::ngp::ngp_mlp_kernel_12"):
        assert profile_render.port_kernel_of(name) == "ngp_mlp"
        assert trace.port_kernel_of(name) is None
