"""The port imports nothing of JAX or of the JAX package, and its entry
points never fall back to the CPU silently."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port imports without jax or the JAX package, and
    without a package the card's machine lacks (safetensors, yaml, cv2,
    PIL, transformers): counted beyond what a bare `import torch, numpy,
    scipy` loads. The checkpoint, LoRA, ControlNet and safety modules, and
    SDXL's, are among those imported."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy, scipy, scipy.fft, torch
        before = set(sys.modules)
        import cremage_tpu_torch.pipelines.sd15
        import cremage_tpu_torch.app.server
        import cremage_tpu_torch as pkg
        names = [info.name for info in
                 pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "cremage_tpu")]
        assert not bad, bad
        assert any(m.startswith("cremage_tpu_torch.") for m in sys.modules)
        absent = ("safetensors", "yaml", "cv2", "PIL", "transformers")
        bad = sorted(m for m in set(sys.modules) - before
                     if m.split(".")[0] in absent)
        assert not bad, bad
        for new in ("io.checkpoint", "io.lora", "io.ti", "pipelines.loader",
                    "prompt.wildcards", "models.controlnet",
                    "models.safety_checker", "services.safety",
                    "services.watermark", "app.backends",
                    "models.open_clip", "samplers.edm", "pipelines.sdxl"):
            assert "cremage_tpu_torch." + new in names, new
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_pipeline_without_device_raises_when_cuda_is_absent(monkeypatch):
    from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline, build_sd15_bundle

    from cremage_tpu_torch.pipelines.sdxl import SDXLPipeline, build_sdxl_bundle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: SD15Pipeline(bundle=None), build_sd15_bundle,
                  lambda: SDXLPipeline(bundle=None), build_sdxl_bundle):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


def test_port_calls_no_library_attention_or_compile():
    """The port's attention is its own kernel: no SDPA, no cuDNN attention
    through the SDP backends, no torch.compile. (chip_smoke.py, outside
    the package, times SDPA as a yardstick only.)"""
    pkg = Path(__file__).resolve().parent.parent / "cremage_tpu_torch"
    banned = ("scaled_dot_product_attention", "torch.compile", "sdp_kernel")
    found = [f"{path.relative_to(pkg)}: {word}"
             for path in sorted(pkg.rglob("*"))
             if path.suffix in (".py", ".cu", ".cuh")
             for word in banned if word in path.read_text()]
    assert not found, found
