"""Kernel 7, the fused spatial probe, and the realtime frame's switches
against the JAX package on the CPU.

The probe is held at the JAX probe test's reduced size
(tests/test_probe_kernels.py: 72x160, 3 tries, radius 24, its seeded
blocky surface and reservoirs). The JAX side runs with both
STROLLE_PROBE_KERNEL=1 and STROLLE_PALLAS_INTERPRET=1, so that its
spatial passes really take its Pallas probe kernel (in interpret mode);
without the first they take the jnp loop. Its passes are called unjitted,
as the JAX test calls them, and each mode's kernel is compiled once per
test process (``_jax_case``).

Kernel 7's route entry (``probe_kernels.probe_route``, the spatial
passes' own) is held without JAX at 24x32, on seeded fields in the
layouts the kernel reads in place: its plain version against the
composition the route replaced (the stack entry's inputs, its plain
version, the mirror, the zeroing and the stream advance), every output
equal; its stream against ``rng.next_u32``; its one-pass tables against
``_draw_probe_tables``, bit-equal.

Tolerances. Accept decisions (oy, ox, found) may differ on at most 0.1%
of pixels: XLA:CPU fuses the multiply-adds of the normal dot and the
Jacobian, PyTorch does not, and a tap on a gate's edge can go either
way (the count is printed). The Jacobian, and a GI pass against the
port's own tensor probe, within 1e-6 in the sense of the JAX probe
test (tests/test_probe_kernels.py, ``_tree_equal``: 1e-6 absolute plus
1e-6 relative): a few float32 ulps of the Jacobian's products and
quotient. Whole spatial passes against the JAX package: integer fields
equal and float fields within the reservoir tolerance of
tests/test_torch_restir_ops.py (rtol 2e-6, atol 1e-7) on all pixels but
at most 0.1%.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import np_tree, scene_arrays

from strolle_tpu.bvh import scene_with_bvh as jax_scene_with_bvh
from strolle_tpu.models import heatmap as jax_heatmap
from strolle_tpu.models import restir as jr
from strolle_tpu.ops import offsets as jax_offsets
from strolle_tpu.ops.pallas.probe_kernels import probe_spatial_pallas
from strolle_tpu.restir import di as jax_di
from strolle_tpu.restir import gi as jax_gi
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu_torch import convert
from strolle_tpu_torch.bvh import scene_with_bvh
from strolle_tpu_torch.camera import contain_xy, pixel_rays, screen_grid, screen_xy
from strolle_tpu_torch.config import DEFAULT_TUNING, Tuning
from strolle_tpu_torch.models import heatmap, restir as tr
from strolle_tpu_torch.ops.hit import Surface
from strolle_tpu_torch.ops.kernels import cuda_lib
from strolle_tpu_torch.ops import offsets as shoff
from strolle_tpu_torch.ops import rng
from strolle_tpu_torch.ops.kernels import probe_kernels as pk
from strolle_tpu_torch.restir import di, gi
from strolle_tpu_torch.restir.gi import GiReservoirs
from strolle_tpu_torch.restir.reservoir import DiReservoirs
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from tests.test_probe_kernels import TUNING as JAX_TUNING
from tests.test_probe_kernels import _camera, _di_res, _gi_res, _surface

TUNING = Tuning(**dataclasses.asdict(JAX_TUNING))
#: Most pixels whose accept decision may differ from another route's.
MAX_FLIPS = 1e-3
RTOL, ATOL = 2e-6, 1e-7
#: The JAX probe test's "within 1e-6".
JAC_TOL = dict(rtol=1e-6, atol=1e-6)
#: (surface seed, reservoirs, spatial seed, frame) of each mode, as the
#: JAX probe test draws them.
CASES = {"di": (0, _di_res, 0xBEEF, 3), "gi": (3, _gi_res, 0xF00D, 5)}


@pytest.fixture()
def kernel_on(monkeypatch):
    monkeypatch.setenv("STROLLE_PROBE_KERNEL", "1")
    monkeypatch.setenv("STROLLE_PALLAS_INTERPRET", "1")


def _port(cls, jax_obj):
    return convert.dataclass_from_arrays(cls, np_tree(jax_obj), "cpu")


@functools.cache
def _jax_case(mode: str) -> dict:
    """One mode's inputs in both packages, the JAX spatial pass with its
    probe kernel on, and the JAX kernel's own outputs on the same stack
    and tables (the same jitted program the pass ran). Call with
    ``kernel_on``."""
    surf_seed, make_res, seed, frame = CASES[mode]
    jscene, jcam, jsurf, jres = jax_cornell_box(), _camera(), _surface(surf_seed), make_res()
    spatial = jax_di.di_spatial if mode == "di" else jax_gi.gi_spatial
    jout = spatial(jscene, jcam, jsurf, jres, jnp.uint32(seed), frame, JAX_TUNING)
    radius = JAX_TUNING.di_spatial_radius if mode == "di" else JAX_TUNING.gi_spatial_radius
    radii = jax_offsets.radius_levels(radius)
    h, w = jsurf.depth.shape
    margin = jax_offsets.probe_margin(radius, h, w)
    tries = JAX_TUNING.di_spatial_samples if mode == "di" else JAX_TUNING.gi_spatial_samples
    dy, dx = jax_di._draw_probe_tables(jnp.uint32(seed), tries, radii, 2, margin)
    planes = [jsurf.depth, *jnp.moveaxis(jsurf.normal, -1, 0),
              jsurf.is_some.astype(jnp.float32), jres.m]
    if mode == "gi":
        planes += [*jnp.moveaxis(jres.v1_point, -1, 0), *jnp.moveaxis(jres.v2_point, -1, 0),
                   *jnp.moveaxis(jres.v2_normal, -1, 0), *jnp.moveaxis(jsurf.point, -1, 0)]
    stack = jnp.stack(planes)
    kw = dict(mode=mode, tries=tries, n_var=2, n_lvls=len(radii), margin=margin,
              depth_tol=0.33, normal_min=0.33)
    if mode == "gi":
        kw.update(jac_reject=JAX_TUNING.gi_jacobian_reject, jac_clamp=JAX_TUNING.gi_jacobian_clamp)
    jprobe = probe_spatial_pallas(stack, dy, dx, jnp.uint32(seed), interpret=True, **kw)
    res_cls = DiReservoirs if mode == "di" else GiReservoirs
    return dict(
        scene=convert.scene_from_arrays(scene_arrays(jscene), device="cpu"),
        cam=convert.camera_from_arrays(np_tree(jcam), device="cpu"),
        surf=_port(Surface, jsurf), res=_port(res_cls, jres), seed=seed, frame=frame,
        jout=np_tree(jout), stack=torch.tensor(np.asarray(stack)),
        dy=torch.tensor(np.asarray(dy)), dx=torch.tensor(np.asarray(dx)), kw=kw,
        jprobe=[np.asarray(x) for x in jprobe],
    )


def _spatial(case: dict, mode: str, use_pallas=None):
    fn = di.di_spatial if mode == "di" else gi.gi_spatial
    return fn(case["scene"], case["cam"], case["surf"], case["res"], case["seed"],
              case["frame"], TUNING, use_pallas)


def _fields(res) -> dict:
    return {f.name: getattr(res, f.name).numpy() for f in dataclasses.fields(res)}


def _assert_reservoirs(got: dict, want: dict, flips: np.ndarray) -> None:
    """Integer fields equal and floats close on every pixel outside
    ``flips`` [H, W]."""
    assert got.keys() == want.keys()
    keep = ~flips
    for k, b in want.items():
        a = got[k].astype(b.dtype) if b.dtype == np.uint32 else got[k]
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a[keep], b[keep], err_msg=k)
        else:
            np.testing.assert_allclose(a[keep], b[keep], rtol=RTOL, atol=ATOL, err_msg=k)


def _decision_flips(got, want) -> np.ndarray:
    """Pixels whose (oy, ox, found) differ between two probes."""
    flips = np.zeros(np.shape(want[2]), bool)
    for a, b in zip(got[:3], want[:3]):
        flips |= np.asarray(a) != np.asarray(b)
    return flips


@pytest.mark.parametrize("mode", ["di", "gi"])
def test_probe_plain_matches_jax_kernel(mode, kernel_on):
    """probe_spatial_plain against the JAX Pallas kernel in interpret mode
    on the same stack, tables and seed."""
    case = _jax_case(mode)
    got = pk.probe_spatial_plain(case["stack"], case["dy"], case["dx"], case["seed"],
                                 **case["kw"])
    want = case["jprobe"]
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.bool] + (
        [torch.float32] if mode == "gi" else [])
    flips = _decision_flips([g.numpy() for g in got], want)
    print(f"{mode}: accept decisions differ on {int(flips.sum())} of {flips.size} pixels; "
          f"found {int(want[2].sum())}")
    assert flips.mean() <= MAX_FLIPS
    assert 0.05 < want[2].mean() < 0.95  # the gates pass and fail
    if mode == "gi":
        np.testing.assert_allclose(got[3].numpy()[~flips], want[3][~flips], **JAC_TOL)
        assert (want[3][want[2]] > 0.0).all()


@pytest.mark.parametrize("mode", ["di", "gi"])
def test_spatial_kernel_route_matches_jax(mode, kernel_on):
    """The port's spatial pass with STROLLE_PROBE_KERNEL=1 (the fused
    probe's plain version on the CPU) against the JAX pass with its probe
    kernel on, field by field."""
    case = _jax_case(mode)
    got = _fields(_spatial(case, mode))
    want = {k: np.asarray(v) for k, v in case["jout"].items()}
    differ = np.zeros(want["m"].shape, bool)
    for k, b in want.items():
        a = got[k]
        differ |= (~np.isclose(a, b.astype(a.dtype), rtol=RTOL, atol=ATOL)).reshape(
            b.shape[:2] + (-1,)).any(-1)
    print(f"{mode}: {int(differ.sum())} pixels differ from the JAX pass")
    assert differ.mean() <= MAX_FLIPS
    _assert_reservoirs(got, want, differ)


@pytest.mark.parametrize("mode", ["di", "gi"])
def test_kernel_route_matches_tensor_route(mode, kernel_on):
    """The port's fused route against its own tensor probe on the same
    inputs: DI equal in every field; GI within 1e-6 on every pixel whose
    accept decision agrees, and at most 0.1% flipped (the two routes
    round the Jacobian differently)."""
    case = _jax_case(mode)
    fused = _fields(_spatial(case, mode))
    tensor = _fields(_spatial(case, mode, use_pallas=False))
    if mode == "di":
        for k in fused:
            np.testing.assert_array_equal(fused[k], tensor[k], err_msg=k)
        return
    state = rng.wnoise_new(case["seed"], *screen_xy(case["cam"]))
    probes = [
        di.probe_fused(case["cam"], case["surf"], gi.probe_planes(case["surf"], case["res"]),
                       case["seed"],
                       TUNING.gi_spatial_samples, TUNING.gi_spatial_radius, state,
                       jac_reject=TUNING.gi_jacobian_reject, jac_clamp=TUNING.gi_jacobian_clamp),
        gi._gi_probe_tensor(case["cam"], case["surf"], gi.probe_taps(case["surf"], case["res"]),
                            case["seed"], TUNING, state),
    ]
    np.testing.assert_array_equal(probes[0][3].numpy(), probes[1][3].numpy())  # the rng state
    flips = _decision_flips(*([p.numpy() for p in pr[:3]] for pr in probes))
    jac_diff = (probes[0][4] - probes[1][4]).abs().numpy()[~flips].max()
    print(f"gi: fused and tensor probes disagree on {int(flips.sum())} pixels; their "
          f"Jacobians differ by up to {jac_diff:.3g} elsewhere")
    assert flips.mean() <= MAX_FLIPS
    for k in fused:
        np.testing.assert_allclose(fused[k][~flips], tensor[k][~flips], err_msg=k, **JAC_TOL)


def test_probe_routes(monkeypatch):
    """The switch off or use_pallas=False takes the tensor probe; on, a
    CPU tensor runs the plain version and launches nothing; the wrapper
    refuses bad stacks and tables."""
    calls = []
    real = pk.probe_spatial_plain

    def plain(*args, **kwargs):
        calls.append(kwargs["mode"])
        return real(*args, **kwargs)

    monkeypatch.setattr(pk, "probe_spatial_plain", plain)
    h, w = 12, 16
    scene, cam = cornell_box(device="cpu"), cornell_camera(w, h, device="cpu")
    rs = np.random.RandomState(3)
    surf = Surface.empty((h, w), "cpu").replace(
        depth=torch.tensor(rs.uniform(1, 2, (h, w)).astype(np.float32)),
        normal=torch.tensor([0.0, 0.0, 1.0]).expand(h, w, 3).contiguous(),
        is_some=torch.ones((h, w), dtype=torch.bool))
    dres = DiReservoirs.empty((h, w), "cpu").replace(m=torch.ones((h, w)))
    gres = GiReservoirs.empty((h, w), "cpu").replace(m=torch.ones((h, w)))
    cuda_lib.reset_launch_counts()
    for env, use_pallas, want in (("0", None, []), ("1", False, []), ("1", None, ["di", "gi"]),
                                  ("1", True, ["di", "gi"])):
        monkeypatch.setenv("STROLLE_PROBE_KERNEL", env)
        calls.clear()
        di.di_spatial(scene, cam, surf, dres, 5, 1, TUNING, use_pallas)
        gi.gi_spatial(scene, cam, surf, gres, 5, 1, TUNING, use_pallas)
        assert calls == want, (env, use_pallas, calls)
    monkeypatch.delenv("STROLLE_PROBE_KERNEL")
    assert not di._probe_kernel_enabled(None)
    assert cuda_lib.LAUNCHES == {}
    stack = torch.zeros((6, h, w))
    tab = torch.zeros(3 * 4 * 2, dtype=torch.int32)
    kw = dict(mode="di", tries=3, n_var=2, n_lvls=4, margin=5, depth_tol=0.33,
              normal_min=0.33)
    pk.probe_spatial(stack, tab, tab, 1, **kw)
    for bad in (dict(stack=torch.zeros((18, h, w))), dict(dy=tab[:-1]),
                dict(dy=tab.to(torch.int64)), dict(margin=h)):
        args = dict(stack=stack, dy=tab, dx=tab, margin=5) | bad
        with pytest.raises(ValueError):
            pk.probe_spatial(args["stack"], args["dy"], args["dx"], 1,
                             **(kw | {"margin": args["margin"]}))


# --- kernel 7's route entry (no JAX) ------------------------------------------

ROUTE_H, ROUTE_W = 24, 32


def _route_pass(mode: str, seed: int = 11):
    """(camera, surface, reservoirs, planes, gi keyword arguments) of a
    seeded spatial pass at ROUTE_H x ROUTE_W, its fields in layouts the
    route entry reads in place: depth every other element of a wider
    buffer, vectors the first three channels of [H, W, 4] buffers (pixel
    stride 4), v1_point a [3, H, W] buffer seen as [H, W, 3], is_some bool;
    depth and is_some blocky, so that the gates pass and fail."""
    h, w = ROUTE_H, ROUTE_W
    rs = np.random.RandomState(seed)

    def blocky(lo, hi):
        return np.repeat(np.repeat(rs.uniform(lo, hi, (h // 4, w // 4)), 4, 0), 4, 1)

    def vec(unit=False, absent=0.0):
        v = rs.normal(size=(h, w, 4))
        if unit:
            v[..., :3] /= np.linalg.norm(v[..., :3], axis=-1, keepdims=True)
        v *= rs.uniform(size=(h, w, 1)) >= absent
        return torch.tensor(v.astype(np.float32))[..., :3]

    depth = torch.tensor(np.repeat(blocky(1.0, 5.0), 2, 1).astype(np.float32))[:, ::2]
    surf = Surface.empty((h, w), "cpu").replace(
        depth=depth, normal=vec(unit=True), is_some=torch.tensor(blocky(0.0, 1.0) > 0.15),
        point=vec())
    m = torch.tensor(((rs.uniform(size=(h, w)) > 0.2) * rs.uniform(1, 8, (h, w)))
                     .astype(np.float32))
    if mode == "di":
        return surf, DiReservoirs.empty((h, w), "cpu").replace(m=m), (m,), {}
    v1 = torch.tensor(rs.normal(size=(3, h, w)).astype(np.float32)).permute(1, 2, 0)
    res = GiReservoirs.empty((h, w), "cpu").replace(
        m=m, v1_point=v1, v2_point=vec(absent=0.1), v2_normal=vec(unit=True))
    gi_kw = dict(jac_reject=DEFAULT_TUNING.gi_jacobian_reject,
                 jac_clamp=DEFAULT_TUNING.gi_jacobian_clamp)
    return surf, res, gi.probe_planes(surf, res), gi_kw


def _tuning_of(mode: str) -> tuple[int, float]:
    t = DEFAULT_TUNING
    return ((t.di_spatial_samples, t.di_spatial_radius) if mode == "di"
            else (t.gi_spatial_samples, t.gi_spatial_radius))


@pytest.mark.parametrize("mode", ["di", "gi"])
def test_route_plain_matches_composition(mode):
    """probe_fused (the route entry's plain version on the CPU) against the
    composition it replaced: probe_inputs' stack and tables,
    probe_spatial_plain, contain_xy, the zeroing and the stream advanced
    by next_u32; every output equal, on strided fields and a bool
    is_some. A field the kernel could not read in place raises."""
    surf, res, planes, gi_kw = _route_pass(mode)
    assert surf.depth.stride() == (2 * ROUTE_W, 2) and surf.normal.stride()[1] == 4
    cam = cornell_camera(ROUTE_W, ROUTE_H, device="cpu")
    tries, radius = _tuning_of(mode)
    seed = 0x5EED + len(mode)
    xs, ys = screen_xy(cam)
    state = rng.wnoise_new(seed, xs, ys)
    got = di.probe_fused(cam, surf, planes, seed, tries, radius, state, **gi_kw)

    stack, dy, dx, kw = di.probe_inputs(surf, planes, seed, tries, radius, **gi_kw)
    assert stack.shape[0] == pk.PLANES[mode]
    out = pk.probe_spatial_plain(stack, dy, dx, seed, **kw)
    cx, cy = contain_xy(cam, xs + out[1], ys + out[0])
    want_state = state
    for _ in range(tries):
        want_state, _ = rng.next_u32(want_state)
    want = (torch.where(out[2], cx, 0), torch.where(out[2], cy, 0), out[2], want_state,
            *out[3:])
    assert len(got) == len(want) == (5 if mode == "gi" else 4)
    for name, a, b in zip(("rhs_x", "rhs_y", "found", "state", "jac"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    found = got[2].float().mean().item()
    assert 0.05 < found < 0.95, found
    if mode == "gi":
        assert (got[4][got[2]] > 0).all()

    fields = (surf.depth, surf.normal, surf.is_some, *planes)
    kw = dict(mode=mode, tries=tries, radii=shoff.radius_levels(radius), n_var=2,
              margin=kw["margin"], depth_tol=0.33, normal_min=0.33, **gi_kw)
    for k, bad in ((0, torch.zeros(ROUTE_H, ROUTE_W + 1)[:, :ROUTE_W]),
                   (1, torch.zeros(ROUTE_H, ROUTE_W, 3, dtype=torch.float64)),
                   (2, surf.is_some.to(torch.float32)), (3, res.m[None])):
        with pytest.raises(ValueError):
            pk.probe_route(fields[:k] + (bad,) + fields[k + 1:], seed, state, **kw)
    with pytest.raises(ValueError):
        pk.probe_route(fields[:4] if mode == "gi" else fields + fields[1:2], seed, state, **kw)


@pytest.mark.parametrize("mode", ["di", "gi"])
def test_route_stream_advances_by_tries(mode):
    """The route entry's returned stream: each pixel's wnoise_new(seed, x,
    y) stepped ``tries`` times by rng.next_u32, bit-equal, an int64 below
    2^32, for 1 to 8 tries."""
    surf, _, planes, gi_kw = _route_pass(mode, seed=5)
    fields = (surf.depth, surf.normal, surf.is_some, *planes)
    xs, ys = screen_xy(cornell_camera(ROUTE_W, ROUTE_H, device="cpu"))
    seed = 0xC0FFEE
    state = rng.wnoise_new(seed, xs, ys)
    radii = shoff.radius_levels(_tuning_of(mode)[1])
    for tries in (1, 3, pk.MAX_TRIES):
        out = pk.probe_route(fields, seed, state, mode=mode, tries=tries, radii=radii, n_var=2,
                             margin=ROUTE_H - 1, depth_tol=0.33, normal_min=0.33, **gi_kw)
        want = state
        for _ in range(tries):
            want, _ = rng.next_u32(want)
        assert out[3].dtype == torch.int64 and torch.equal(out[3], want), tries
        assert int(out[3].max()) <= rng.MASK32 and int(out[3].min()) >= 0


@pytest.mark.parametrize("mode", ["di", "gi"])
def test_tables_drawn_in_one_pass(mode):
    """draw_tables_plain, the plain twin of the tables each block of the
    route entry draws, against _draw_probe_tables (one
    offsets.draw_offset_table per try), bit-equal: at the mode's tuning
    with the full margin and with a margin that clamps, over seeds that
    span the u32 range; and the route entry's tables_out equal to them."""
    tries, radius = _tuning_of(mode)
    radii = shoff.radius_levels(radius)
    for seed in (0, 7, 0xBEEF, 0xFFFFFFFF, 0x9E3779B9):
        for margin in (int(radius), 9):
            want = di._draw_probe_tables(seed, tries, radii, 2, margin, "cpu")
            got = pk.draw_tables_plain(seed, tries, radii, 2, margin, "cpu")
            for a, b in zip(got, want):
                assert a.dtype == torch.int32 and torch.equal(a, b), (seed, margin)
            assert int(got[0].abs().max()) <= margin and int(got[1].abs().max()) <= margin
    surf, _, planes, gi_kw = _route_pass(mode)
    seed, margin = 0xBEEF, 9
    tables = torch.full((2, tries * len(radii) * 2), -99, dtype=torch.int32)
    pk.probe_route((surf.depth, surf.normal, surf.is_some, *planes), seed,
                   torch.zeros((ROUTE_H, ROUTE_W), dtype=torch.int64), mode=mode, tries=tries,
                   radii=radii, n_var=2, margin=margin, depth_tol=0.33, normal_min=0.33,
                   tables_out=tables, **gi_kw)
    assert torch.equal(tables, torch.stack(di._draw_probe_tables(seed, tries, radii, 2, margin,
                                                                 "cpu")))


# --- the frame's switches -------------------------------------------------

SWITCHES = {
    "default": {},
    "no_gi": dict(needs_gi=False),
    "no_di": dict(needs_di=False),
    "no_denoise": dict(denoise=False),
    "di_only_raw": dict(needs_gi=False, denoise=False),
}
STAGES = ("_stage_prelude", "_stage_history", "_stage_di", "_stage_gi", "_stage_denoise",
          "_stage_denoise_pair", "_stage_compose")


def _record_stages(monkeypatch, mod, xp, h, w, calls: list) -> None:
    """Replaces each stage of ``mod`` (either package's models/restir.py)
    by a stub that records its call and returns constant planes: the
    outputs that reach the composition say which stage made them."""
    def planes(value, c):
        return xp.full((h, w, c), float(value))

    def stub(name):
        def fn(*args, **kwargs):
            calls.append(name)
            if name == "_stage_prelude":
                return ("surf", "reproj", "sky", "bn1", "bn2")
            if name == "_stage_history":
                return ("di_rhs", "gi_rep", "rhs_surf")
            if name == "_stage_di":
                return planes(1, 4), planes(2, 4), "di_prev'"
            if name == "_stage_gi":
                return planes(3, 4), planes(4, 4), "gi_prev'"
            if name == "_stage_denoise":
                kind = args[5] if len(args) > 5 else kwargs["kind"]
                return planes(5 if kind == "di" else 6, 3), f"{kind}_den'"
            if name == "_stage_denoise_pair":
                return (planes(5, 3), "di_den'"), (planes(6, 3), "gi_den'")
            return {"compose": [float(x.mean()) for x in args[1:]]}
        return fn

    for name in STAGES:
        monkeypatch.setattr(mod, name, stub(name))


def _state_fields(state) -> dict:
    return {k: getattr(state, k) if isinstance(getattr(state, k), str) else "kept"
            for k in ("di_prev", "gi_prev", "di_diff_denoiser", "gi_diff_denoiser")}


@pytest.mark.parametrize("name", list(SWITCHES))
def test_render_config_switches_follow_jax(name, monkeypatch):
    """RenderConfig(denoise, needs_di, needs_gi) against the JAX
    package's render_frame with every stage replaced by a recorder in
    both: the same stages run in the same order, the same stage outputs
    (or zeros) reach the composition, the same state fields pass through,
    and the LUTs are fetched only for the sky or GI."""
    h, w = 6, 8
    flags = SWITCHES[name]
    luts_calls = {"jax": 0, "port": 0}
    import strolle_tpu.sky.atmosphere as jax_atm

    def fake_luts(key):
        def fn(*args, **kwargs):
            luts_calls[key] += 1
            return "luts"
        return fn

    monkeypatch.setattr(jax_atm, "luts_for", fake_luts("jax"))
    monkeypatch.setattr(tr, "luts_for", fake_luts("port"))
    jcalls, calls = [], []
    _record_stages(monkeypatch, jr, jnp, h, w, jcalls)
    _record_stages(monkeypatch, tr, torch, h, w, calls)
    jcam, cam = jax_cornell_camera(w, h), cornell_camera(w, h, device="cpu")
    jstate = jr.init_state(jcam)
    state = tr.init_state(cam, device="cpu")
    jch, jnew = jr.render_frame(jax_cornell_box(), jcam, jstate, jnp.uint32(1),
                                jr.RenderConfig(**flags))
    ch, new = tr.render_frame(cornell_box(device="cpu"), cam, state, 1, tr.RenderConfig(**flags))
    assert calls == jcalls
    assert ch == jch
    assert luts_calls["port"] == luts_calls["jax"]
    assert _state_fields(new) == _state_fields(jnew)
    assert new.frame == int(jnew.frame) == 1


def test_switched_frames_run():
    """A frame of the port with each switch at 16x12, after one default
    frame: every channel finite; a channel
    that is off is zero and its reservoirs and denoiser state pass
    through unchanged; with the denoiser off the diffuse channels are the
    raw samples."""
    scene, cam = cornell_box(device="cpu"), cornell_camera(16, 12, device="cpu")
    # GI samples the sky LUTs for its miss rays: small constant ones
    luts = convert.luts_from_arrays(
        {k: np.full((8, 8, 3), 0.1, np.float32) for k in ("transmittance", "scattering", "sky")},
        device="cpu")
    _, state = tr.render_frame(scene, cam, tr.init_state(cam, device="cpu"), 40, luts=luts)
    for name, flags in SWITCHES.items():
        ch, new = tr.render_frame(scene, cam, state, 50, tr.RenderConfig(**flags), luts)
        for k, v in ch.items():
            assert bool(torch.isfinite(v).all()), (name, k)
        needs_di, needs_gi = flags.get("needs_di", True), flags.get("needs_gi", True)
        denoise = flags.get("denoise", True)
        for off, chans, kept in ((not needs_di, ("di_diffuse", "di_specular"),
                                  ("di_prev", "di_diff_denoiser")),
                                 (not needs_gi, ("gi_diffuse", "gi_specular"),
                                  ("gi_prev", "gi_diff_denoiser"))):
            if off:
                for k in chans:
                    assert not ch[k].any(), (name, k)
                for k in kept:
                    assert getattr(new, k) is getattr(state, k), (name, k)
        if not denoise:
            assert new.di_diff_denoiser is state.di_diff_denoiser
            assert new.gi_diff_denoiser is state.gi_diff_denoiser
        assert float(ch["image"].mean()) > 0.01, name


# --- the heatmap -------------------------------------------------------------

@pytest.mark.parametrize("with_bvh", [False, True])
def test_heatmap_matches_jax(with_bvh):
    """render_heatmap and trace_cost on Cornell at 16x12, with and without
    a BVH: the byte costs of the port's primary rays equal the JAX
    package's on the same rays, the colours within 1e-6."""
    jscene = jax_cornell_box()
    if with_bvh:
        jscene = jax_scene_with_bvh(jscene)
    scene = convert.scene_from_arrays(scene_arrays(jscene), device="cpu")
    if with_bvh:
        assert scene.bvh is not None
        assert torch.equal(scene_with_bvh(cornell_box(device="cpu")).bvh.child,
                           scene.bvh.child)
    cam = cornell_camera(16, 12, device="cpu")
    o, d = pixel_rays(cam, screen_grid(cam))
    want_cost = np.asarray(jax_heatmap.trace_cost(jscene, jnp.asarray(o.numpy()),
                                                  jnp.asarray(d.numpy())))
    got_cost = heatmap.trace_cost(scene, o, d).numpy()
    np.testing.assert_array_equal(got_cost, want_cost)
    assert got_cost.dtype == np.float32
    if with_bvh:
        assert np.ptp(got_cost) > 0  # the walk's cost varies over the image
    else:
        assert (got_cost == 36 * 160).all()
    # the gradient over the costs and over a ramp past both ends
    ramp = np.linspace(-0.5, 1.5, 41, dtype=np.float32)
    progress = np.concatenate([got_cost.reshape(-1) / heatmap.HEATMAP_SCALE, ramp])
    want = np.asarray(jax.jit(jax_heatmap.heatmap_gradient)(jnp.asarray(progress)))
    got = heatmap.render_heatmap(scene, cam).numpy()
    assert got.shape == (12, 16, 3)
    np.testing.assert_allclose(got.reshape(-1, 3), want[:-41], rtol=0, atol=1e-6)
    np.testing.assert_allclose(heatmap.heatmap_gradient(torch.tensor(ramp)).numpy(), want[-41:],
                               rtol=0, atol=1e-6)
    assert heatmap.HEATMAP_SCALE == jax_heatmap.HEATMAP_SCALE
