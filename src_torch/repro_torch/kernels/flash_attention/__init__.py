"""Attention with explicit positions — GQA, causal and sliding-window
masks, logit softcap — for every attention call of the LM serving path,
prefill and ring-buffer decode alike."""
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
