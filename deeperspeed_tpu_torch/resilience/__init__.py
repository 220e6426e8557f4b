"""Fault tolerance. Counterpart of deeperspeed_tpu/resilience/; ported so
far: ``manifest`` (checkpoint manifests, commit markers and valid-tag
discovery, which ``Engine.load_checkpoint`` uses), ``reshard``'s
``remap_data_state`` (the datapipe cursor on restore), ``faults`` (the
fault plan and injector; the serving replica worker fires its decode-step
faults) and ``supervisor``'s ``compute_backoff`` (the router's retry and
restart backoff)."""
