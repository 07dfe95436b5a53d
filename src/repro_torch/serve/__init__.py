# Cached autoregressive inference: the KV cache and prefill / decode.
