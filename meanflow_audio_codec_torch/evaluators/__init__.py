"""Evaluation layer: samplers, metrics, performance, comprehensive eval;
counterpart of ``meanflow_audio_codec_tpu/evaluators``."""

from meanflow_audio_codec_torch.evaluators.analysis import (
    aggregate,
    analyze_results,
    plot_metric_vs_nfe,
    write_summary_csv,
)
from meanflow_audio_codec_torch.evaluators.audio_metrics import (
    bsd,
    log_mel_spectrogram,
    mel_filterbank,
    nsim,
    pesq_score,
    si_snr,
    spectral_distance,
    stoi,
    stoi_to_intelligibility,
)
from meanflow_audio_codec_torch.evaluators.comprehensive_evaluator import (
    DEFAULT_NFE_SWEEP,
    ComprehensiveEvaluator,
)
from meanflow_audio_codec_torch.evaluators.metrics import (
    batch_psnr,
    batch_ssim,
    fid,
    frechet_distance,
    kernel_inception_distance,
    kid,
    psnr,
    ssim,
)
from meanflow_audio_codec_torch.evaluators.performance import (
    TrainingTimer,
    count_parameters,
    inference_time,
    memory_profiler,
    memory_usage,
)

# the samplers live in ops/ but are part of the evaluator API
from meanflow_audio_codec_torch.ops.sampling import sample, sample_dual_time
