"""The program under test, as the benchmark drives it: the only module of the
benchmark that imports ``meanflow_audio_codec_torch``, and only through its
own entry points (``AudioCodec``, ``TrainState``, ``DeviceReplayPool``,
``make_multi_step``, ``create_loss_strategy``, ``adapter_from_config``).

Weights come from the benchmark (the model family's ``draw``), mapped onto
the program's parameter names by the family's ``to_port``, which the caller
hands in; the model is built on the meta device and filled on the card, so
set-up draws nothing leaf by leaf on the host.
"""

from __future__ import annotations

import torch


def port_config(config: dict):
    from meanflow_audio_codec_torch.configs import config_from_dict

    return config_from_dict(config)


def build_model(config, params: dict, to_port, device, quantized: bool = False):
    from meanflow_audio_codec_torch.codec import with_quantized_decoder
    from meanflow_audio_codec_torch.models.factories import create_flow_model

    if quantized:
        config = with_quantized_decoder(config)
    with torch.device("meta"):
        model = create_flow_model(config)
    model = model.to_empty(device=device)
    model.load_state_dict(to_port(params, model.state_dict().keys()), strict=True)
    return model


def codec(config, params: dict, to_port, device, quantized: bool = False):
    """``AudioCodec`` over the benchmark's weights (its int8 decoder with
    ``quantized``)."""
    from meanflow_audio_codec_torch.codec import AudioCodec, with_quantized_decoder

    model = build_model(config, params, to_port, device, quantized)
    if quantized:
        config = with_quantized_decoder(config)
    return AudioCodec(model, None, config, device=device)


class Trainer:
    """The train state, replay pool and chunk steps ``train_flow`` builds
    for this config (``training/trainer.py``), over the benchmark's weights
    and batch source."""

    def __init__(self, config, params: dict, to_port, source, seed: int, device):
        from meanflow_audio_codec_torch.data.device_pool import DeviceReplayPool
        from meanflow_audio_codec_torch.ops.tokenize import create_tokenization_strategy
        from meanflow_audio_codec_torch.training.adapter import adapter_from_config
        from meanflow_audio_codec_torch.training.objectives import create_loss_strategy
        from meanflow_audio_codec_torch.training.optim import TrainState, make_optimizer
        from meanflow_audio_codec_torch.training.trainer import device_pool_clips

        self.config = config
        model = build_model(config, params, to_port, device)
        self.state = TrainState(model, make_optimizer(config),
                                config.ema_decay or None, device=device)
        self.pool = DeviceReplayPool(source, pool_clips=device_pool_clips(config),
                                     seed=seed, device=device)
        self.objective = create_loss_strategy(config)
        strategy = create_tokenization_strategy(config.tokenization_strategy,
                                                config.tokenization_config)
        self.adapter = adapter_from_config(config, strategy)
        self._chunks = {}

    def chunk(self, k: int):
        """``make_multi_step`` of ``k`` steps, as the trainer's ``chunk_fn``."""
        from meanflow_audio_codec_torch.training.train_step import make_multi_step

        if k not in self._chunks:
            self._chunks[k] = make_multi_step(
                self.objective, k, self.adapter, remat=self.config.remat,
                skip_nonfinite=self.config.skip_nonfinite_updates)
        return self._chunks[k]

    def names(self) -> list[str]:
        return list(self.state.names)

    def close(self) -> None:
        self.pool.close()

