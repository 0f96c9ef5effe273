"""DVQ-AE encoders, the Step 5 refresh and the protocol state (port of
``repro.core``)."""
