from repro_torch.models.transformer import (decode_step, embed_tokens,
                                            extend_step, forward, init,
                                            logits_fn)

__all__ = ["decode_step", "embed_tokens", "extend_step", "forward", "init",
           "logits_fn"]
