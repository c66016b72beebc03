"""Write ``tests/fixtures/torch_orbax_run/``: a tiny convnet codec run whose
checkpoint the JAX package wrote in the orbax format, for the PyTorch port
to read without JAX, tensorstore or zstandard (``chip_smoke.py``'s orbax
phase and ``tests/test_torch_orbax.py``).

    python tests/make_torch_orbax_fixture.py [--out DIR]

The run holds ``config.json``, ``checkpoints/step_00003.orbax/`` with its
``step_00003.metadata.json`` sidecar (JAX's
``save_checkpoint_with_metadata(fmt="orbax")``), and
``twin/step_00003.msgpack``, the same train state through JAX's msgpack
``save_checkpoint``. The twin sits outside ``checkpoints/`` so that
``from_workdir`` serves the orbax directory. The weights are the model's
seeded initialisation; the AdamW moments and the EMA are seeded normals,
so that every leaf differs from its neighbours.
"""

import argparse
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from meanflow_audio_codec_tpu.configs import TrainFlowConfig  # noqa: E402
from meanflow_audio_codec_tpu.models.factories import (  # noqa: E402
    create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import (  # noqa: E402
    TrainState,
)
from meanflow_audio_codec_tpu.training import checkpoints  # noqa: E402
from meanflow_audio_codec_tpu.training.logging import save_json  # noqa: E402
from meanflow_audio_codec_tpu.training.trainer import (  # noqa: E402
    make_optimizer,
)

OUT = REPO / "tests" / "fixtures" / "torch_orbax_run"
STEP = 3
WINDOW = 32
CONFIG = {
    "config_version": "2.0",
    "base": {"batch_size": 2, "n_steps": STEP, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 5, "grad_clip_norm": 1.0},
    "model": {"noise_dimension": 2 * WINDOW, "condition_dimension": 8,
              "latent_dimension": 8, "num_blocks": 2,
              "architecture": "convnet",
              "architecture_options": {"channels": 8, "bottleneck_dim": 16,
                                       "spatial": 4, "lift_channels": 4}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {"frame_size": 2048,
                                        "window_size": WINDOW,
                                        "coeff_scale": 4.0,
                                        "gain_norm": 0.05}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True},
    "training": {"sample_every": 2, "sample_seed": 1, "sample_steps": 1,
                 "workdir": "torch_orbax_run", "ema_decay": 0.99,
                 "checkpoint_format": "orbax"},
    "tpu": {"precision": "float32"},
}


def make_state(config: TrainFlowConfig):
    model = create_flow_model(config)
    params = model.init(jax.random.PRNGKey(config.seed),
                        jnp.zeros((2, config.noise_dimension)),
                        jnp.zeros((2, 2)), method="init_all")["params"]
    rng = np.random.default_rng(config.seed)

    def normal(scale):
        return lambda a: jnp.asarray(
            scale * rng.standard_normal(np.shape(a)), jnp.float32)

    state = TrainState.create(
        apply_fn=None, params=params, tx=make_optimizer(config),
        ema_params=jax.tree_util.tree_map(normal(0.1), params),
        ema_decay=config.training.ema_decay)
    # nonzero moments and counts, as after STEP updates
    opt_state = jax.tree_util.tree_map(
        lambda a: (normal(0.01)(a) if a.dtype == jnp.float32
                   else jnp.asarray(STEP, a.dtype)), state.opt_state)
    return state.replace(step=jnp.asarray(STEP, jnp.int32),
                         opt_state=opt_state)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    config = TrainFlowConfig.from_dict(CONFIG)
    state = make_state(config)
    if args.out.exists():
        shutil.rmtree(args.out)
    save_json(config.to_dict(), args.out / "config.json")
    checkpoints.save_checkpoint_with_metadata(
        state, args.out / "checkpoints", step=STEP, config=config,
        fmt="orbax")
    checkpoints.save_checkpoint(state,
                                args.out / "twin" / f"step_{STEP:05d}.msgpack")
    total = sum(f.stat().st_size for f in args.out.rglob("*") if f.is_file())
    print(f"wrote {args.out} ({total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
