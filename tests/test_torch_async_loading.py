"""The port's asynchronous model loading (``models/whisper/loader.py::
resolve_files_async`` / ``build_model_async``, ``Definition.try_to_model``):
the twins of tests/test_async_loading.py.

The three files of one load fetch concurrently, two loads awaited together
overlap, a speculative build resolves its draft's files alongside the
target's, the quantize_self_kv guard fires before any download, and the
blocking and async builds agree.  Downloads go through a patched
``_hub_download`` that sleeps, so wall clock separates serial from
concurrent fetches.
"""

import asyncio
import time

import pytest

pytest.importorskip("tokenizers")

import norma_tpu_torch.models.whisper.loader as loader_mod  # noqa: E402
from checkpoint_fixture import make_checkpoint_dir  # noqa: E402
from norma_tpu_torch.decode import SpeculativeEngine  # noqa: E402
from norma_tpu_torch.models import SelectedDevice  # noqa: E402
from norma_tpu_torch.models.whisper import monolingual, multilingual  # noqa: E402

SLEEP = 0.15


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    make_checkpoint_dir(str(d))
    return str(d)


def _fake_download(ckpt, log):
    def dl(repo_id, filename, revision):
        log.append(("start", filename, time.perf_counter()))
        time.sleep(SLEEP)
        log.append(("end", filename, time.perf_counter()))
        return f"{ckpt}/{filename}"

    return dl


def test_one_load_fetches_files_concurrently(ckpt, monkeypatch):
    log = []
    monkeypatch.setattr(loader_mod, "_hub_download", _fake_download(ckpt, log))
    t0 = time.perf_counter()
    files = asyncio.run(loader_mod.resolve_files_async("repo", "main", None))
    dt = time.perf_counter() - t0
    assert files.config.endswith("config.json")
    assert len([e for e in log if e[0] == "start"]) == 3
    assert dt < 2 * SLEEP, f"downloads did not overlap: {dt:.3f}s"


def test_two_model_loads_overlap(ckpt, monkeypatch):
    log = []
    monkeypatch.setattr(loader_mod, "_hub_download", _fake_download(ckpt, log))
    d1 = monolingual.Definition(monolingual.ModelType.TINY_EN, SelectedDevice.cpu())
    d2 = monolingual.Definition(monolingual.ModelType.TINY_EN, SelectedDevice.cpu())

    async def go():
        return await asyncio.gather(d1.try_to_model(), d2.try_to_model())

    m1, m2 = asyncio.run(go())
    starts = sorted(t for op, _, t in log if op == "start")
    ends = sorted(t for op, _, t in log if op == "end")
    assert len(starts) == 6
    assert starts[3] < ends[0], "downloads ran serially"
    assert ends[-1] - starts[0] < 4 * SLEEP
    assert m1.engine is not None and m2.engine is not None


def test_speculative_draft_downloads_overlap_target(ckpt, monkeypatch):
    log = []
    monkeypatch.setattr(loader_mod, "_hub_download", _fake_download(ckpt, log))
    model = asyncio.run(loader_mod.build_model_async(
        repo_id="target-repo", revision="main", quantized_ext=None, device=SelectedDevice.cpu(),
        const_language_token_str=None, draft_repo_id="draft-repo",
    ))
    starts = sorted(t for op, _, t in log if op == "start")
    ends = sorted(t for op, _, t in log if op == "end")
    assert len(starts) == 6, "expected 3 target + 3 draft downloads"
    assert starts[3] < ends[0], "draft downloads ran serially after target"
    assert ends[-1] - starts[0] < 4 * SLEEP
    assert isinstance(model.engine, SpeculativeEngine)


def test_async_spec_flag_guard_fires_before_downloads(ckpt, monkeypatch):
    log = []
    monkeypatch.setattr(loader_mod, "_hub_download", _fake_download(ckpt, log))
    with pytest.raises(ValueError, match="quantize_self_kv"):
        asyncio.run(loader_mod.build_model_async(
            repo_id="target-repo", revision="main", quantized_ext=None, device=SelectedDevice.cpu(),
            draft_repo_id="draft-repo", quantize_self_kv=True,
        ))
    assert not log, "downloads started despite the invalid flag combination"


def test_blocking_and_async_build_agree(ckpt):
    for d in (
        monolingual.Definition(monolingual.ModelType.TINY_EN, SelectedDevice.cpu(), local_dir=ckpt),
        multilingual.Definition(multilingual.ModelType.TINY, SelectedDevice.cpu(), local_dir=ckpt,
                                draft_local_dir=ckpt, spec_k=2),
    ):
        blocking = d.blocking_try_to_model()
        a = asyncio.run(d.try_to_model())
        assert type(a.engine) is type(blocking.engine)
        assert a.engine.cfg == blocking.engine.cfg
