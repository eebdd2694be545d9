"""Model families of the port: the Llama decoder (serving over the dense
or paged cache, with multi-tenant adapters; the LoRA fine-tune) and BERT
for sequence classification (the fine-tune path)."""

from tpudl_torch.models.bert import (  # noqa: F401
    BERT_BASE,
    BERT_LARGE,
    BERT_TINY,
    BertConfig,
    BertForSequenceClassification,
)
from tpudl_torch.models.generate import generate  # noqa: F401
from tpudl_torch.models.llama import (  # noqa: F401
    LLAMA3_1B,
    LLAMA3_8B,
    LLAMA_TINY,
    LlamaConfig,
    LlamaForCausalLM,
    init_params,
    params_from_tpudl,
)
