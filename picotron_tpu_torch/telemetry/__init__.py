"""Telemetry of the port. Only the event bus is ported so far (`bus`);
sinks, phases and the goodput ledger are ROADMAP Queue 1 item 12."""
