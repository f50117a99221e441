from show_and_tell_tpu_torch.evalsuite.driver import evaluation, language_eval, make_caption_fn  # noqa: F401
