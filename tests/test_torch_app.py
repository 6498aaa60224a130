"""Headless run of the port's streamlit app (``simumax_tpu_torch/app``).

The stub of ``tests/test_app.py`` (every widget returns its default, the
buttons and checkboxes return True so every render path runs), with the
sidebar's ``device`` select set to ``cpu``: the estimate, simulate and
search tabs render through the port's planner, and the assertions are
``tests/test_app.py``'s. The module also imports without streamlit
(its body is ``main()``).
"""

import importlib
import runpy
import sys
import types

import pytest

pytest.importorskip("torch")

import test_app  # noqa: E402

APP = "/".join(__file__.split("/")[:-2]) + "/simumax_tpu_torch/app/streamlit_app.py"
_run_path = runpy.run_path


class _CpuRecorder(test_app._Recorder):
    """The stub, with the device select set to the CPU."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def _child(self):
        child = super()._child()
        child.devices = self.devices
        return child

    def selectbox(self, label, options, index=0):
        if label == "device":
            self._rec("selectbox", label)
            self.devices.append(list(options))
            return "cpu"
        return super().selectbox(label, options, index)


@pytest.fixture()
def stub_streamlit(monkeypatch):
    rec = _CpuRecorder()
    mod = types.ModuleType("streamlit")
    for name in dir(rec):
        if not name.startswith("_"):
            setattr(mod, name, getattr(rec, name))
    monkeypatch.setitem(sys.modules, "streamlit", mod)
    return rec


def test_port_app_renders_estimate_and_simulation(stub_streamlit, tmp_path, monkeypatch):
    """``tests/test_app.py``'s run and assertions on the port's app."""
    monkeypatch.setattr(runpy, "run_path",
                        lambda _path, run_name: _run_path(APP, run_name=run_name))
    test_app.test_app_renders_estimate_and_simulation(stub_streamlit, tmp_path, monkeypatch)
    assert stub_streamlit.devices == [["cuda", "cpu"]]  # the card first, as --device


def test_port_app_imports_without_streamlit(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", None)
    mod = importlib.import_module("simumax_tpu_torch.app.streamlit_app")
    assert callable(mod.main)
    with pytest.raises(ImportError):
        mod.main()
