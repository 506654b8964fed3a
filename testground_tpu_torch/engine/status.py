"""Task status hooks: GitHub commit statuses + Slack webhook (a copy of
``testground_tpu/engine/status.py``)
(reference pkg/engine/supervisor.go:192-296).

Both hooks are gated on daemon config (absent token/URL → no-op) and drive an
injectable ``poster(url, headers, body)`` so tests assert payloads without
network. Failures are logged, never fatal — status posting must not affect
the run (the reference logs and continues, supervisor.go:84-113).
"""

from __future__ import annotations

import copy
import json
import threading
import urllib.request
from typing import Callable, Optional

from ..logging import S
from ..task.task import (
    OUTCOME_CANCELED,
    OUTCOME_FAILURE,
    OUTCOME_SUCCESS,
    STATE_CANCELED,
    STATE_COMPLETE,
    STATE_PROCESSING,
    Task,
)

Poster = Callable[[str, dict, bytes], None]


def _http_poster(url: str, headers: dict, body: bytes) -> None:
    req = urllib.request.Request(url, data=body, method="POST")
    for k, v in headers.items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=10) as resp:
        resp.read()


def _took(task: Task) -> str:
    if len(task.states) < 2:
        return ""
    secs = task.states[-1].created - task.states[0].created
    return f"{secs:.1f}s"


class StatusReporter:
    """Posts task state transitions outward; one instance per engine."""

    def __init__(
        self,
        github_token: str = "",
        slack_webhook_url: str = "",
        tasks_url: str = "",
        poster: Optional[Poster] = None,
    ) -> None:
        self.github_token = github_token
        self.slack_webhook_url = slack_webhook_url
        self.tasks_url = tasks_url or "http://localhost:8042/tasks"
        self._post = poster or _http_poster

    @property
    def enabled(self) -> bool:
        return bool(self.github_token or self.slack_webhook_url)

    # ------------------------------------------------------------- public
    def post(self, task: Task) -> None:
        """Best-effort post to every configured sink. Runs the HTTP calls in
        a daemon thread so a slow sink never stalls the scheduler worker.

        The task is snapshotted SYNCHRONOUSLY: the worker may transition the
        live Task (e.g. processing → complete) before the thread serializes
        it, which would skip the 'pending' status and double-post completion."""
        if not self.enabled:
            return
        snap = copy.copy(task)
        snap.states = list(task.states)
        snap.created_by = dict(task.created_by)
        threading.Thread(
            target=self._post_sync, args=(snap,), daemon=True
        ).start()

    def _post_sync(self, task: Task) -> None:
        for fn in (self.post_github, self.post_slack):
            try:
                fn(task)
            except Exception as e:  # never fatal (supervisor.go:84-113)
                S().warnf("status post failed: %s", e)

    # ------------------------------------------------------------- github
    def post_github(self, task: Task) -> None:
        """Commit status on the originating repo (supervisor.go:192-259).
        Requires created_by {repo: "owner/repo", commit: sha} and a token."""
        if not self.github_token:
            return
        repo = task.created_by.get("repo", "")
        commit = task.created_by.get("commit", "")
        if "/" not in repo or not commit:
            return  # not created by CI
        if task.state == STATE_PROCESSING:
            state, msg = "pending", "TaaS is running your plan"
        elif task.state in (STATE_COMPLETE, STATE_CANCELED):
            outcome = task.outcome
            if outcome == OUTCOME_SUCCESS:
                state, msg = "success", "Testplan run succeeded!"
            elif outcome in (OUTCOME_FAILURE, OUTCOME_CANCELED):
                state, msg = "failure", f"Testplan run {outcome}!"
            else:
                return
        else:
            return
        url = f"https://api.github.com/repos/{repo}/statuses/{commit}"
        payload = {
            "state": state,
            "target_url": self.tasks_url,
            "description": msg,
            "context": f"taas/{task.plan}/{task.case}",
        }
        self._post(
            url,
            {
                "Authorization": "Basic " + self.github_token,
                "Accept": "application/vnd.github.v3+json",
                "Content-Type": "application/json",
            },
            json.dumps(payload).encode(),
        )

    # -------------------------------------------------------------- slack
    def post_slack(self, task: Task) -> None:
        """Completion message to a Slack webhook (supervisor.go:262-296)."""
        if not self.slack_webhook_url or task.state not in (
            STATE_COMPLETE,
            STATE_CANCELED,
        ):
            return
        link = f"<{self.tasks_url}#taskID_{task.id}|{task.id}>"
        name = task.name or f"{task.plan}/{task.case}"
        outcome = task.outcome
        if outcome == OUTCOME_SUCCESS:
            text = f"✅ {link} *{name}* run succeeded {_took(task)}"
        elif outcome == OUTCOME_CANCELED:
            text = f"⚪ {link} *{name}* run canceled {_took(task)} ; {task.error}"
        elif outcome == OUTCOME_FAILURE:
            text = f"❌ {link} *{name}* run failed {_took(task)} ; {task.error}"
        else:
            text = f"{link} *{name}* run completed"
        self._post(
            self.slack_webhook_url,
            {"Content-Type": "application/json; charset=UTF-8"},
            json.dumps({"text": text}).encode(),
        )
