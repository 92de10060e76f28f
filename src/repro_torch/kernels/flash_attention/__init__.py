"""Online-softmax GQA attention (causal, sliding window, softcap)."""
