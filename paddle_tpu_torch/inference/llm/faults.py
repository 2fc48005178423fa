"""Request terminal states.  Only ``FinishReason`` is ported so far; fault
injection, retry, the step watchdog and migration errors come with the
faults slice."""


class FinishReason:
    """Terminal states of a request.  ``stop`` and ``length`` are the
    "done" family (generation ran to completion); everything else names
    the failure path that ended the request early."""

    STOP = "stop"          # hit eos_token_id
    LENGTH = "length"      # hit max_new_tokens
    ABORTED = "aborted"    # abort_request() / client vanished
    DEADLINE = "deadline"  # missed its deadline_ms
    SHED = "shed"          # bounded admission rejected it (queue full)
    ERROR = "error"        # device step failed; request quarantined

    DONE = (STOP, LENGTH)
    ALL = (STOP, LENGTH, ABORTED, DEADLINE, SHED, ERROR)

    @staticmethod
    def is_done(reason):
        """True when generation completed normally."""
        return reason in FinishReason.DONE
