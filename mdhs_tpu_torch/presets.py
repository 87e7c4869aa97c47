"""The served configurations, resolved from the repository's YAML configs.

``MIBF_HAM_SERVING`` is the int8 serving preset of
``configs/serving/mibf_ham_serving.yml``, ``HAM_FUSION_SSM`` and
``HAM_HEAD_MOE`` the baseline configurations of
``configs/ham/ham_fusion_ssm_v1.yml`` and ``ham_head_moe_v1.yml``, and
``CONNEXT_HAM`` the ConNexT configuration of
``configs/connext/connext_ham.yml``, resolved (the card's machine has no
yaml reader; tests hold each equal to its YAML).
"""

from __future__ import annotations

import dataclasses

from .models.baseline import BaselineConfig
from .models.bert import BertConfig
from .models.connext import ConNexTConfig


@dataclasses.dataclass(frozen=True)
class ServingPreset:
    """A serving configuration: the text tower, the static batch, the
    tokenizer length and the label count."""

    bert: BertConfig
    batch_size: int
    seq_len: int
    num_labels: int


# configs/serving/mibf_ham_serving.yml over configs/mibf/mibf_ham.yml:
# model.fast_math true, model.text_encoder.quantize int8 (BERT-base preset),
# inference.batch_size 512, tokenizer.max_length 256, model.num_classes 7.
MIBF_HAM_SERVING = ServingPreset(
    bert=BertConfig(fast_math=True, quantize="int8"), batch_size=512, seq_len=256, num_labels=7,
)

# configs/ham/ham_fusion_ssm_v1.yml and ham_head_moe_v1.yml over configs/common/base.yml
# (BaselineConfig.from_config + bert_config_from: BERT-base, hidden 256, dropout 0.3,
# 7 classes); batch 64 (training.batch_size), seq 128 (tokenizer.max_length).
HAM_FUSION_SSM = BaselineConfig(dropout=0.3, fusion_type="mamba", classifier_type="mlp")
HAM_HEAD_MOE = BaselineConfig(dropout=0.3, fusion_type="multiscale", classifier_type="moe")
BASELINE_BATCH, BASELINE_SEQ = 64, 128

# configs/connext/connext_ham.yml over configs/common/base.yml (the JAX Trainer's
# build_model for family "connext"): ConvNeXt-base, BERT-base, fusion 768, the MoE head
# (model.moe.enabled) of 4 KAN experts [768, 512, 128, 32, 7], top-2, 7 classes; batch 32
# (training.batch_size, the batch run_predict takes), seq 512 (tokenizer.max_length),
# canvas 256 cropped to 224 (data.canvas, data.image_size). model.moe.balance_weight
# weighs the returned balance loss in training, on top of the MoE's own 1e-2 coefficient.
CONNEXT_HAM = ConNexTConfig(head="moe", moe_num_experts=4, moe_k=2)
CONNEXT_BATCH, CONNEXT_SEQ, CONNEXT_CANVAS, CONNEXT_CROP = 32, 512, 256, 224
CONNEXT_BALANCE_WEIGHT = 0.01
