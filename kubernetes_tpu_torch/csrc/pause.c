/* ktpu-pause: the per-pod sandbox anchor process.
 *
 * The capability (reference behavior: build/pause/pause.c — behavioral
 * spec only, implemented here with a different design): one tiny real
 * process per pod sandbox that
 *   - keeps the sandbox alive until the kubelet tears it down,
 *   - acts as the pod's PID 1, reaping any orphaned children that get
 *     re-parented onto it,
 *   - exits promptly and cleanly on SIGTERM/SIGINT.
 *
 * Design: no asynchronous signal handlers at all.  The interesting
 * signals are BLOCKED up front and consumed synchronously with
 * sigwaitinfo(2) in the main loop — child reaping and shutdown then run
 * in ordinary program context, so there is no async-signal-safety
 * surface to reason about.  (The reference era used handler-based
 * dispatch; a synchronous wait loop is the simpler modern shape.)
 *
 * Built by kubernetes_tpu_torch.native.pause_binary(); spawned per sandbox by
 * kubelet/runtime.py ProcessSandboxManager.
 */

#define _POSIX_C_SOURCE 200809L

#include <errno.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <sys/wait.h>
#include <unistd.h>

enum {
  EXIT_CLEAN = 0,
  EXIT_BAD_MASK = 10,   /* could not block the signal set */
  EXIT_WAIT_FAILED = 11 /* sigwaitinfo failed (not EINTR) */
};

static void reap_children(void) {
  /* collect every available corpse; children may exit in bursts */
  pid_t got;
  do {
    got = waitpid(-1, NULL, WNOHANG);
  } while (got > 0);
}

int main(int argc, char **argv) {
  sigset_t interesting;

  for (int i = 1; i < argc; i++) {
    if (strcmp(argv[i], "--version") == 0) {
      puts("ktpu-pause 2.0 (sigwait loop)");
      return EXIT_CLEAN;
    }
  }

  sigemptyset(&interesting);
  sigaddset(&interesting, SIGTERM);
  sigaddset(&interesting, SIGINT);
  sigaddset(&interesting, SIGCHLD);
  if (sigprocmask(SIG_BLOCK, &interesting, NULL) != 0) {
    perror("ktpu-pause: sigprocmask");
    return EXIT_BAD_MASK;
  }

  for (;;) {
    siginfo_t info;
    int signo = sigwaitinfo(&interesting, &info);
    if (signo < 0) {
      if (errno == EINTR)
        continue;
      perror("ktpu-pause: sigwaitinfo");
      return EXIT_WAIT_FAILED;
    }
    if (signo == SIGCHLD) {
      reap_children();
      continue;
    }
    /* SIGTERM / SIGINT: the kubelet (or an operator) wants us gone */
    fprintf(stderr, "ktpu-pause: exiting on %s\n", strsignal(signo));
    return EXIT_CLEAN;
  }
}
