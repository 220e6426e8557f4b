"""Fault tolerance. Counterpart of deeperspeed_tpu/resilience/; ported so
far: ``manifest`` (checkpoint manifests, commit markers and valid-tag
discovery, which ``Engine.load_checkpoint`` uses) and ``reshard``'s
``remap_data_state`` (the datapipe cursor on restore)."""
