"""ptzjax_torch parity on the CPU: config, synthetic renderer and geometry
against the JAX package."""

import dataclasses
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import geometry as jgeo
from ptzjax import synth as jsynth
from ptzjax.config import SLAMConfig
from ptzjax_torch import geometry as tgeo
from ptzjax_torch import synth as tsynth
from ptzjax_torch.config import SLAMConfig as PortConfig
from tests._torch_port import n, t

torch.set_num_threads(2)


class TestPackage:
    def test_import_pulls_in_no_jax(self):
        """Every module of the package, found by walking it (not a hand-kept
        list), imports without pulling in jax or the JAX package."""
        code = (
            "import importlib, pkgutil, sys, ptzjax_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(ptzjax_torch.__path__, 'ptzjax_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ptzjax'))\n"
            "assert not bad, bad\n"
            "print(' '.join(names))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120, capture_output=True, text=True)
        names = set(out.stdout.split())
        for mod in ("checkpoint", "eval", "kernels.flow", "convert", "kernels.harris_nms", "kernels.window_gather", "soak"):
            assert f"ptzjax_torch.{mod}" in names


class TestConfig:
    def test_fields_and_defaults_match(self):
        ref = {f.name: f.default for f in dataclasses.fields(SLAMConfig)}
        port = {f.name: f.default for f in dataclasses.fields(PortConfig)}
        assert list(port) == list(ref)
        assert port == ref

    def test_json_round_trip(self):
        cfg = PortConfig(max_rays=64, mesh_shape=(2, 2), reloc_mode="map")
        assert PortConfig.from_json(cfg.to_json()) == cfg
        assert json.loads(cfg.to_json()) == json.loads(
            SLAMConfig(max_rays=64, mesh_shape=(2, 2)).to_json()
        )
        assert cfg.replace(max_rays=8).max_rays == 8

    def test_unknown_key_warns(self):
        d = json.loads(PortConfig().to_json())
        d["nms_cell"] = 4
        with pytest.warns(UserWarning, match="nms_cell"):
            assert PortConfig.from_json(json.dumps(d)) == PortConfig()


class TestSynth:
    def test_bitwise_equal_to_reference(self):
        kw = dict(pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02, f0=1100.0, f_amp=60.0, period=48.0, seed=3)
        np.testing.assert_array_equal(
            tsynth.make_trajectory(30, **kw), jsynth.make_trajectory(30, **kw)
        )
        pk = dict(theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2), texels_per_rad=2200.0, seed=3)
        tp, jp = tsynth.make_panorama(**pk), jsynth.make_panorama(**pk)
        np.testing.assert_array_equal(tp.tex, jp.tex)
        assert tp[1:] == jp[1:]
        cam = jsynth.make_trajectory(3, **kw)[2]
        img_t = tsynth.render_image(tp, cam, tgeo.Intrinsics.create(320.0, 180.0), 640, 360)
        img_j = jsynth.render_image(jp, cam, jgeo.Intrinsics.create(320.0, 180.0), 640, 360)
        assert img_t.dtype == np.float32
        np.testing.assert_array_equal(img_t, img_j)


def _geometry_inputs(seed=0):
    rng = np.random.default_rng(seed)
    cams = np.stack(
        [rng.uniform(-0.5, 0.5, 4), rng.uniform(-0.2, 0.1, 4), rng.uniform(800, 4000, 4)], -1
    ).astype(np.float32)
    rays = (cams[:, None, :2] + rng.uniform(-0.3, 0.3, (4, 50, 2))).astype(np.float32)
    # poles, behind the camera and far outside the clip: must stay finite
    rays[:, -4:] = [[0.0, 1.5707964], [3.1415927, 0.0], [-3.0, -1.5], [2.0, 1.4]]
    pix = rng.uniform([0, 0], [1280, 720], (4, 50, 2)).astype(np.float32)
    return cams, rays, pix


class TestGeometry:
    intr_args = (640.0, 360.0)

    def test_projection_functions_match(self):
        cams, rays, pix = _geometry_inputs()
        ji = jgeo.Intrinsics.create(*self.intr_args)
        ti = tgeo.Intrinsics.create(*self.intr_args)
        for a, b in zip(ji, ti):
            np.testing.assert_array_equal(a, b)
        tol = dict(rtol=1e-5, atol=1e-6)
        cases = [
            (jgeo.project_rays(jnp.asarray(cams), jnp.asarray(rays), ji),
             tgeo.project_rays(t(cams), t(rays), ti)),
            (jgeo.back_project_pixels(jnp.asarray(cams), jnp.asarray(pix), ji),
             tgeo.back_project_pixels(t(cams), t(pix), ti)),
            (jgeo.residuals(jnp.asarray(cams), jnp.asarray(rays), jnp.asarray(pix), ji),
             tgeo.residuals(t(cams), t(rays), t(pix), ti)),
            (jgeo.clip_angle(jnp.asarray(rays)), tgeo.clip_angle(t(rays))),
        ]
        for ref, got in cases:
            assert np.isfinite(n(got)).all()
            np.testing.assert_allclose(n(got), n(ref), **tol)
        np.testing.assert_array_equal(
            n(tgeo.in_view_mask(t(cams), t(rays), ti, 1280, 720, margin=50.0)),
            n(jgeo.in_view_mask(jnp.asarray(cams), jnp.asarray(rays), ji, 1280, 720, margin=50.0)),
        )

    def test_jacobians_match_and_identity(self):
        cams, rays, _ = _geometry_inputs(1)
        ji = jgeo.Intrinsics.create(*self.intr_args)
        ti = tgeo.Intrinsics.create(*self.intr_args)
        ref = jgeo.project_jacobians(jnp.asarray(cams), jnp.asarray(rays), ji)
        got = tgeo.project_jacobians(t(cams), t(rays), ti)
        for r, g in zip(ref, got):
            assert np.isfinite(n(g)).all()
            np.testing.assert_allclose(n(g), n(r), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(n(got[2]), -n(got[1])[..., :2])

    def test_rays_from_points(self):
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(40, 3)).astype(np.float32) * 20 + [0, 5, 40]
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        args = (640.0, 360.0, np.array([1.0, -2.0, 0.5], np.float32), rot)
        np.testing.assert_allclose(
            n(tgeo.rays_from_points(t(pts), tgeo.Intrinsics.create(*args))),
            n(jgeo.rays_from_points(jnp.asarray(pts), jgeo.Intrinsics.create(*args))),
            rtol=1e-5, atol=1e-6,
        )

    def test_round_trip(self):
        cams, rays, _ = _geometry_inputs(3)
        ti = tgeo.Intrinsics.create(*self.intr_args)
        inside = t(rays[:, :-4])
        back = tgeo.back_project_pixels(t(cams), tgeo.project_rays(t(cams), inside, ti), ti)
        np.testing.assert_allclose(n(back), n(inside), atol=1e-5)
