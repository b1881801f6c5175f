"""The share (%) of the traced stretch's wall in which the recurrence ran
on the host: the union of the program's ``cnn_lstm.lstm`` spans (a
forward call of the LSTM) and of the library's own backward op
(``aten::_cudnn_rnn_backward``, its backward pass on the card), the
recurrence's share of a pass as the host sees it, in the train cells.
None for a program without the span.  Layer: Model
(``models/cnn_lstm.lstm_apply``)."""

from benchmark.core.trace import _union

SPAN, BACKWARD = "cnn_lstm.lstm", "aten::_cudnn_rnn_backward"


def read(rec):
    if rec["stretch_s"] <= 0 or not any(h[0] == SPAN for h in rec["host"]):
        return None
    lo, hi = rec["stretch"]
    spans = _union([h for h in rec["host"] if h[0] in (SPAN, BACKWARD)],
                   lo, hi)
    return 100.0 * sum(e - s for s, e in spans) / rec["stretch_s"]
