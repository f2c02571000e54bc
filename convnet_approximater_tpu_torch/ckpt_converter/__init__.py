"""Key rewrites of flat checkpoints (the counterparts of ``scripts/ckpt_converter/``):
:mod:`.add_substitution` and :mod:`.remove_substitution`."""
