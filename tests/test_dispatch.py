"""DP backend selection (ops/dispatch.py): `auto` picks the device
executor over the CUDA kernel on a GPU and the inline host path
elsewhere; explicit modes name their executor and core."""

import types

import pytest

from multiz_jax.ops import dispatch
from multiz_jax.ops import yama_pack as YP


def _fake_platform(monkeypatch, platform):
    import jax

    monkeypatch.setattr(
        jax, "devices", lambda *a: [types.SimpleNamespace(platform=platform)]
    )


def test_auto_selects_device_on_gpu(monkeypatch):
    monkeypatch.delenv("MULTIZ_DEVICE", raising=False)
    _fake_platform(monkeypatch, "gpu")
    fn = dispatch.default_batch_fn()
    assert fn is YP.yama_batch_packed
    assert fn.stream_cls is YP.PackedDPStream  # streaming, core "cuda"


@pytest.mark.parametrize("platform", ["cpu", "metal"])
def test_auto_is_inline_without_gpu(monkeypatch, platform):
    monkeypatch.setenv("MULTIZ_DEVICE", "auto")
    _fake_platform(monkeypatch, platform)
    assert dispatch.default_batch_fn() is None


def test_jax_mode_streams_the_plain_core(monkeypatch):
    monkeypatch.setenv("MULTIZ_DEVICE", "jax")
    fn = dispatch.default_batch_fn()
    assert fn.keywords == {"core": "xla"}
    assert fn.stream_cls().core == "xla"


@pytest.mark.parametrize("mode,want", [
    ("none", None), ("off", None), ("host", dispatch.host_batch),
    ("packed", YP.yama_batch_packed),
])
def test_explicit_modes(monkeypatch, mode, want):
    monkeypatch.setenv("MULTIZ_DEVICE", mode)
    assert dispatch.default_batch_fn() is want


def test_unknown_mode_rejected(monkeypatch):
    monkeypatch.setenv("MULTIZ_DEVICE", "pallas")
    with pytest.raises(ValueError):
        dispatch.default_batch_fn()
