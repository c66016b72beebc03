"""PyTorch port: ``tools/download_wavegen.py``. ``--synthesize`` writes the
JAX tool's WAV files byte for byte (through the port's own ``write_wav``);
the download path raises the JAX tool's ``ImportError`` without its
optional packages. No download is run: it needs the network."""

import builtins

import pytest

from meanflow_audio_codec_tpu.tools import download_wavegen as jax_tool
from meanflow_audio_codec_torch.tools import download_wavegen as tool


def test_synthesize_writes_the_jax_tool_bytes(tmp_path, capsys):
    assert tool.main(["--synthesize", "--out-dir", str(tmp_path / "port"),
                      "--num-files", "3"]) == 0
    assert "Wrote 3 synthetic WAV files" in capsys.readouterr().out
    jax_tool.synthesize(tmp_path / "jax", num_files=3, seconds=5.0)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"synthetic_{i:03d}.wav" for i in range(3)]
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


@pytest.mark.parametrize("missing", ["datasets", "yt_dlp"])
def test_download_without_its_packages_raises_jax_message(tmp_path,
                                                          monkeypatch,
                                                          missing):
    real_import = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name.split(".")[0] == missing:
            raise ImportError(f"No module named {missing!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", refuse)
    with pytest.raises(ImportError) as ours:
        tool.download(tmp_path, limit=1)
    with pytest.raises(ImportError) as theirs:
        jax_tool.download(tmp_path, limit=1)
    assert str(ours.value) == str(theirs.value)
    assert "--synthesize" in str(ours.value)
    assert not any(tmp_path.iterdir())
