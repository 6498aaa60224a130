from simumax_tpu_torch.models.llm import LLMModel, LLMBlock  # noqa: F401
