"""The model zoo (port of ``paddle_tpu/models/``): the Llama, Mixtral,
T5, GPT and BERT / ERNIE families, and the PP-YOLOE detector. Each
language-model constructor takes ``device=None``
(``"cuda"``) and ``seed=0``, and each causal LM has ``sharding_rules()``
(``(parameter-name regex, partition spec)`` pairs over the hybrid mesh's
axes), kept as data for the distributed package. The reference's
pipeline descriptions (``LlamaForCausalLMPipe``, ``build_llama_pipe``,
``GPTForCausalLMPipe``) are not ported yet. PP-YOLOE's layers land on
``paddle.get_device()``, as the vision models' do."""
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel, ErnieConfig,
                   ErnieForSequenceClassification, ErnieModel, bert_base,
                   bert_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  gpt3_1p3b, gpt_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaModel, LlamaPretrainingCriterion, llama3_8b,
                    llama_tiny)
from .mixtral import (MixtralConfig, MixtralForCausalLM,  # noqa: F401
                      MixtralModel, MixtralSparseMoeBlock, mixtral_8x7b,
                      mixtral_tiny)
from .ppyoloe import (PPYOLOE, CSPBackbone, DetectionLoss,  # noqa: F401
                      ETHead, FPNNeck, ppyoloe_lite)
from .pretrained import (bert_config_from_hf,  # noqa: F401
                         llama_config_from_hf, load_bert_from_hf,
                         load_gpt_from_hf, load_hf_config,
                         load_llama_from_hf, load_t5_from_hf,
                         t5_config_from_hf)
from .t5 import T5Config, T5ForConditionalGeneration, t5_tiny  # noqa: F401

__all__ = [
    "LlamaConfig", "LlamaModel", "LlamaForCausalLM",
    "LlamaPretrainingCriterion", "llama3_8b", "llama_tiny",
    "MixtralConfig", "MixtralModel", "MixtralForCausalLM",
    "MixtralSparseMoeBlock", "mixtral_8x7b", "mixtral_tiny",
    "T5Config", "T5ForConditionalGeneration", "t5_tiny",
    "GPTConfig", "GPTModel", "GPTForCausalLM", "gpt3_1p3b", "gpt_tiny",
    "BertConfig", "BertModel", "BertForSequenceClassification",
    "BertForPretraining", "ErnieConfig", "ErnieModel",
    "ErnieForSequenceClassification", "bert_base", "bert_tiny",
    "PPYOLOE", "DetectionLoss", "ppyoloe_lite", "CSPBackbone", "FPNNeck",
    "ETHead", "load_hf_config", "llama_config_from_hf",
    "bert_config_from_hf", "t5_config_from_hf", "load_llama_from_hf",
    "load_gpt_from_hf", "load_bert_from_hf", "load_t5_from_hf",
]
