"""utils/flops.py against the JAX package's utils/flops.py: every analytic
count equal for all seven presets (and at the packing and mined-negative
settings the trainer uses), the roofline equal, and the peak tables: an
H100 row by its torch.cuda name, no peak for the CPU, for another card's
name or for a TPU's kind (no TPU row is copied, and no default stands in
for an unknown card)."""
import pytest
import torch

from dnn_page_vectors_tpu import config as jax_config
from dnn_page_vectors_tpu.utils import flops as jax_flops
from dnn_page_vectors_tpu_torch import config as torch_config
from dnn_page_vectors_tpu_torch.utils import flops

PRESETS = sorted(torch_config.CONFIGS)


def test_the_presets_are_the_jax_presets():
    assert len(PRESETS) == 7
    assert PRESETS == sorted(jax_config.CONFIGS)


def _pair(name, overrides=None):
    return (jax_config.get_config(name, overrides),
            torch_config.get_config(name, overrides))


@pytest.mark.parametrize("name", PRESETS)
def test_counts_equal_jax(name):
    j, t = _pair(name)
    for seq_len in (t.data.query_len, t.data.page_len, 7):
        assert flops.encoder_flops_per_example(t.model, seq_len) == \
            jax_flops.encoder_flops_per_example(j.model, seq_len)
    vocab = t.data.vocab_size
    assert flops.encoder_param_count(t.model, vocab) == \
        jax_flops.encoder_param_count(j.model, vocab)
    assert flops.embed_flops_per_page(t) == jax_flops.embed_flops_per_page(j)
    for batch in (1, 256, t.train.batch_size):
        assert flops.train_flops_per_pair(t, batch) == \
            jax_flops.train_flops_per_pair(j, batch)
        assert flops.train_bytes_per_pair(t, batch) == \
            jax_flops.train_bytes_per_pair(j, batch)
    for pack in (1, 4):
        assert flops.train_flops_per_pair(t, 512, pack=pack) == \
            jax_flops.train_flops_per_pair(j, 512, pack=pack)


@pytest.mark.parametrize("name", PRESETS)
def test_counts_equal_jax_with_packing_and_negatives(name):
    ov = {"train.pack_pages": 4, "train.hard_negatives": 3,
          "model.shared_towers": True}
    j, t = _pair(name, ov)
    assert flops.train_flops_per_pair(t, 1_024) == \
        jax_flops.train_flops_per_pair(j, 1_024)
    assert flops.train_bytes_per_pair(t, 1_024) == \
        jax_flops.train_bytes_per_pair(j, 1_024)


def test_roofline_equals_jax():
    cases = [(1e9, 1e6, 989.4e12, 3.35e12), (1e6, 1e9, 989.4e12, 3.35e12),
             (1e9, 1e6, None, 3.35e12), (1e9, 1e6, 1e12, None),
             (0.0, 0.0, 1e12, 1e12)]
    for case in cases:
        assert flops.roofline(*case) == jax_flops.roofline(*case)


def test_unknown_encoders_raise_like_jax():
    import dataclasses
    j, t = _pair("cdssm_toy")
    for fn in ("encoder_flops_per_example", "encoder_param_count"):
        arg = 16 if fn == "encoder_flops_per_example" else 100
        with pytest.raises(ValueError):
            getattr(jax_flops, fn)(dataclasses.replace(j.model,
                                                       encoder="rnn"), arg)
        with pytest.raises(ValueError, match="rnn"):
            getattr(flops, fn)(dataclasses.replace(t.model, encoder="rnn"),
                               arg)


def test_peaks_are_nvidia_rows_only():
    h100 = "NVIDIA H100 80GB HBM3"
    assert flops.device_peak_flops(h100) == 989.4e12
    assert flops.device_peak_hbm_bps(h100) == 3.35e12
    for other in ("NVIDIA A100-SXM4-80GB", "TPU v5p", "v5litepod",
                  "NVIDIA H100 PCIe"):
        assert flops.device_peak_flops(other) is None
        assert flops.device_peak_hbm_bps(other) is None
    # the CPU has no peak: no MFU is reported there
    for dev in ("cpu", torch.device("cpu")):
        assert flops.device_peak_flops(dev) is None
        assert flops.device_peak_hbm_bps(dev) is None
    if not torch.cuda.is_available():
        assert flops.device_peak_flops(None) is None
        assert flops.device_peak_flops("cuda") is None


def test_trainer_logs_no_mfu_on_the_cpu():
    """The trainer's line has pages_per_sec_per_chip, and no mfu where the
    peak is unknown."""
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    ov = {"data.num_pages": 64, "data.trigram_buckets": 512,
          "model.embed_dim": 16, "model.conv_channels": 16,
          "model.out_dim": 16, "train.batch_size": 16, "train.log_every": 1,
          "model.dtype": "float32"}
    tr = Trainer(torch_config.get_config("cdssm_toy", ov), device="cpu")
    line = tr.train(1)
    assert "mfu" not in line and "hbm_gb_in_use" not in line
    assert line["pages_per_sec_per_chip"] == line["pages_per_sec"]
