"""Analysis (counterpart of ``nezha_tpu/analysis``): the telemetry
schema (:mod:`.telemetry_schema`). The source lint rules are not ported
(ROADMAP A7)."""
